"""The benchmark's FLOP and byte counts against counts made by hand at the
smoke sizes, and its parameter counts against the program's."""
import json
import os

import pytest

from benchkit import specs

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "testdata",
                    "configs")


def _cfg(name):
    cfg = json.load(open(os.path.join(DATA, name)))
    cfg["_name"] = name
    return cfg


def test_mamba2_hand_counts():
    c = specs.family(_cfg("mamba2-smoke.json")).Counts(
        _cfg("mamba2-smoke.json"))
    # D 128, 4 layers, V 512, N 128, P 64, d_inner 256, 4 heads, 4 taps:
    # 128 * (512 + 256 + 4) + 256 * 128 + 4 * (256 + 256) = 133,632 a layer
    assert c.layer_params == 133_632
    assert c.scan_flops_per_token() == 5 * 4 * 64 * 128 == 163_840
    assert c.token_flops() == 4 * (2 * 133_632 + 163_840) == 1_724_416
    assert c.prefill_flops([16, 32]) == 48 * 1_724_416 + 2 * 2 * 512 * 128
    assert c.decode_flops([5, 9, 100]) == 3 * (1_724_416 + 2 * 512 * 128)
    # 48 rows: x 512 B, dt 16, B and C 512, y 1,024 a row; 2 states of
    # 4 x 64 x 128 f32; A 16
    assert c.ssd_launch([16, 32]) == (48 * 163_840,
                                      48 * 2064 + 2 * 131_072 + 16)
    assert c.paged_attention_launch(1, 2, 3) is None


def test_deepseek_v2_hand_counts():
    cfg = _cfg("deepseek-v2-smoke.json")
    c = specs.family(cfg).Counts(cfg)
    # 128*48 + 48*4*192 + 128*96 + 32*4*256 + 4*128*128
    assert c.attn_params == 153_600
    assert c.moe_active_params == 1024 + 2 * 3 * 128 * 64 + 3 * 128 * 128
    assert c.token_flops() == 2 * (3 * 153_600 + 98_304 + 2 * 99_328)
    assert c.pair_flops == 2 * 4 * 192 + 2 * 4 * 128 == 2560
    # 3 tokens: 6 causal pairs in each of 3 layers, one row of logits
    assert c.prefill_flops([3]) == 3 * 1_515_520 + 3 * 2560 * 6 \
        + 2 * 512 * 128
    assert c.decode_flops([10]) == 1_515_520 + 3 * 2560 * 10 \
        + 2 * 512 * 128
    # 20 live [ckv | kr] rows of 96 bf16 + a position; 2 rows of q, q2
    # and the output (4 heads x 128); 20 pairs of 2 * 4 * 128 FLOPs
    assert c.paged_attention_launch(2, 20, 20) == (20 * 1024,
                                                   20 * 196 + 2 * 4 * 128 * 2)
    assert c.ssd_launch([4]) is None


@pytest.mark.parametrize("name", ["mamba2-smoke.json",
                                  "deepseek-v2-smoke.json"])
def test_params_match_the_program(name):
    from repro_torch.models.lm import count_params
    cfg = _cfg(name)
    fam = specs.family(cfg)
    assert fam.Counts(cfg).params() == count_params(fam.build(cfg))


# Rotary and routing the program does not run: DeepSeek-V2's published ones
# (hf deepseek-ai/DeepSeek-V2) and DeepSeek-V3's sigmoid scoring
OTHER = {"rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                              "mscale": 0.707, "mscale_all_dim": 0.707,
                              "original_max_position_embeddings": 4096,
                              "type": "yarn"},
             "n_group": 8, "topk_group": 3,
             "topk_method": "group_limited_greedy",
             "routed_scaling_factor": 16, "norm_topk_prob": False,
             "scoring_func": "sigmoid"}


@pytest.mark.parametrize("key", sorted(OTHER))
def test_deepseek_v2_refuses_what_the_program_cannot_run(key):
    cfg = _cfg("deepseek-v2-smoke.json")
    fam = specs.family(cfg)
    cfg[key] = fam.RUNS[key]
    assert fam.build(cfg) is not None
    cfg[key] = OTHER[key]
    with pytest.raises(ValueError, match=key):
        fam.build(cfg)


@pytest.mark.parametrize("name", ["mamba2-1.3b.json"])
def test_full_size_params_match_the_program(name):
    from repro_torch.models.lm import count_params
    cfg = json.load(open(os.path.join(specs.BENCH_DIR, "configs", name)))
    cfg["_name"] = name
    fam = specs.family(cfg)
    assert fam.Counts(cfg).params() == count_params(fam.build(cfg))
