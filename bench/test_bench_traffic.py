"""The traffic generator: the same seed gives the same requests; other
seeds give the same sizes and gaps in another order."""
import numpy as np
import pytest

from benchkit import traffic

MIX = {"loop": "open", "rate_per_s": 3.0, "warmup_s": 2,
       "prompt_len": {"choices": [256, 512, 1024], "weights": [.5, .3, .2]},
       "output_len": {"uniform": [64, 192]}, "template_seed": 7}


def _key(reqs):
    return [(r.due, tuple(r.prompt), r.max_new) for r in reqs]


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**32 + 123])
def test_repeats_exactly(seed):
    a = traffic.open_loop(MIX, seed, 10, 1000)
    b = traffic.open_loop(MIX, seed, 10, 1000)
    assert _key(a) == _key(b)
    assert all(r.prompt.dtype == np.int32 for r in a)
    assert all(0 <= r.prompt.min() and r.prompt.max() < 1000 for r in a)


def test_seeds_share_the_schedule():
    """Other seeds: the same arrivals and sizes in the same order, other
    tokens."""
    a = traffic.open_loop(MIX, 1, 10, 1000)
    b = traffic.open_loop(MIX, 2, 10, 1000)
    assert len(a) == len(b) == traffic.count_for(MIX, 10)
    assert [(r.due, len(r.prompt), r.max_new) for r in a] == \
        [(r.due, len(r.prompt), r.max_new) for r in b]
    assert _key(a) != _key(b)
    assert sorted(set(len(r.prompt) for r in a)) == [256, 512, 1024]
    assert 64 <= min(r.max_new for r in a) <= max(r.max_new for r in a) \
        <= 192
    gaps = np.diff([0.0] + [r.due for r in a])
    assert abs(gaps.mean() * MIX["rate_per_s"] - 1) < 0.3


def test_enough_requests_for_the_window():
    reqs = traffic.open_loop(MIX, 3, 30, 1000)
    assert reqs[-1].due > MIX["warmup_s"] + 30


def test_possible_lengths():
    assert traffic.possible_lengths(MIX["prompt_len"]) == [256, 512, 1024]
    assert traffic.possible_lengths({"uniform": [3, 6]}) == [3, 4, 5, 6]


def test_lognormal_law():
    """A lognormal law: its median near the stated one, every draw whole
    and inside the clip, and every clipped length possible."""
    law = {"lognormal": {"median": 1020, "sigma": 0.5}, "clip": [256, 2048]}
    x = traffic._lengths(law, np.random.default_rng(5), 4000)
    assert x.dtype.kind == "i" and x.min() >= 256 and x.max() <= 2048
    assert abs(np.median(x) / 1020 - 1) < 0.05
    assert traffic.possible_lengths(law) == list(range(256, 2049))
