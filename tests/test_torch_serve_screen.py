"""Admission screens SSM prompt lengths (``serve.engine._EngineBase._screen``).

The chunked SSD scan prefills a prompt longer than its chunk (256) only
in whole chunks, and a prompt shorter than ``d_conv - 1`` cannot fill the
conv state: both packages raise on such a prompt at prefill. Both engines
reject it at admission instead, with ``finish_reason`` and a stats count
``rejected_ssm_length``, as they reject a prompt over capacity; nothing
leaves ``run`` and the rest of the trace is served with the tokens it gets
without the rejected prompts. A config without SSM blocks serves the same
lengths.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.lm import lm_init
from repro_torch.serve.engine import PagedServeEngine, Request, ServeEngine

torch.set_num_threads(1)

# 300 > chunk 256 and not a multiple; 2 < d_conv - 1 = 3; 256 and 512 fill
# whole chunks; 3 fills the conv state
LENS = (6, 300, 2, 9, 256, 3, 512)
BAD = {300, 2}


def _engine(kind, cfg, params):
    if kind == "fixed":
        return ServeEngine(cfg, params, slots=2, capacity=528, device="cpu")
    return PagedServeEngine(cfg, params, slots=2, page_size=16,
                            pages_per_slot=33, device="cpu")


def _trace(cfg, lens):
    r = np.random.default_rng(7)
    return [Request(rid=i, prompt=r.integers(1, cfg.vocab, n), max_new=3)
            for i, n in enumerate(lens)]


@pytest.mark.parametrize("kind", ["paged", "fixed"])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b"])
def test_ssm_prompts_the_scan_cannot_take_are_rejected(kind, arch):
    cfg = get_config(arch, smoke=True)
    params = lm_init(torch.Generator().manual_seed(0), cfg, "cpu")
    eng = _engine(kind, cfg, params)
    trace = _trace(cfg, LENS)
    eng.run(trace)
    for req in trace:
        assert req.done
        if len(req.prompt) in BAD:
            assert req.finish_reason == "rejected_ssm_length"
            assert req.out == []
        else:
            assert req.finish_reason == "length"
            assert len(req.out) == req.max_new
    assert eng.stats["rejected_ssm_length"] == len(BAD)
    assert eng.stats["rejected_over_capacity"] == 0
    kept = [r for r in trace if len(r.prompt) not in BAD]
    alone = _trace(cfg, LENS)
    alone = [r for r in alone if len(r.prompt) not in BAD]
    _engine(kind, cfg, params).run(alone)
    assert [r.out for r in alone] == [r.out for r in kept]


@pytest.mark.parametrize("kind", ["paged", "fixed"])
def test_attention_config_serves_those_lengths(kind):
    cfg = get_config("qwen3-14b", smoke=True)
    params = lm_init(torch.Generator().manual_seed(0), cfg, "cpu")
    eng = _engine(kind, cfg, params)
    trace = _trace(cfg, (300, 2))
    eng.run(trace)
    assert all(r.finish_reason == "length" and len(r.out) == 3
               for r in trace)
    assert eng.stats["rejected_ssm_length"] == 0
