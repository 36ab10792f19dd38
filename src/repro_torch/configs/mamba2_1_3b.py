"""mamba2-1.3b [ssm]: pure SSD (state-space duality), attention-free.
[arXiv:2405.21060]"""
from repro_torch.configs.common import (BlockSpec, ModelConfig, ScanGroup,
                                        SsmSpec)


def _build(d_model, vocab, n_layers, d_state, name):
    block = BlockSpec(ssm=SsmSpec(d_state=d_state, head_dim=64, expand=2))
    return ModelConfig(name=name, d_model=d_model, vocab=vocab,
                       groups=(ScanGroup((block,), n_layers),),
                       tie_embeddings=True)


CONFIG = _build(2048, 50280, 48, 128, "mamba2-1.3b")
SMOKE = _build(128, 512, 4, 16, "mamba2-1.3b-smoke")
