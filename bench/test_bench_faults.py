"""The check that decides ``correct`` fails a run whose timed path is
broken underneath (each fault a served cell can have), and its control
(the reference through float8) fails the limit that sound runs meet."""
import time

import numpy as np
import pytest

import calibrate
import run as R
from benchkit import specs


def _line(root, cell, seed=11, **kw):
    bench = specs.Bench(str(root))
    res = R.run_cell(bench, bench.cell(cell), seed, 2.0, False, "cpu",
                     time.perf_counter(), **kw)
    return res, R.result_line(res, {"platform": "cpu"}, False)


@pytest.mark.parametrize("cell", ["ssm-smoke", "mla-smoke"])
def test_token_altered_where_produced(smoke_root, monkeypatch, cell):
    from repro_torch.serve.engine import PagedServeEngine
    step = PagedServeEngine._step_executable

    def altered(self):
        return (np.asarray(step(self)) + 1) % self.cfg.vocab

    monkeypatch.setattr(PagedServeEngine, "_step_executable", altered)
    _, line = _line(smoke_root, cell)
    assert line["correct"] is False


def test_ssm_state_left_unchanged(smoke_root, monkeypatch):
    from repro_torch.models import ssm
    monkeypatch.setattr(ssm, "_write", lambda cache, new: None)
    _, line = _line(smoke_root, "ssm-smoke")
    assert line["correct"] is False


def test_ssd_chunk_carry_dropped(smoke_root, monkeypatch):
    """Each chunk of the prefill's SSD scan starts from a zero state: the
    prompts of two and three chunks, and every token decoded after them,
    go wrong."""
    from repro_torch.models import ssm
    monkeypatch.setattr(ssm, "ssd_chunked",
                        calibrate.drop_chunk_carry(ssm.ssd_chunked))
    _, line = _line(smoke_root, "ssm-smoke")
    assert line["correct"] is False


def test_kv_pool_left_unchanged(smoke_root, monkeypatch):
    """No KV row reaches the pool: the paged path's leaf write and the
    gather path's scatter (the CPU's) both dropped."""
    from repro_torch.models import attention, lm
    monkeypatch.setattr(attention, "_paged_leaf_update",
                        lambda cache, entries, positions: cache)
    monkeypatch.setattr(lm, "paged_scatter",
                        lambda pool, *a, **k: pool)
    _, line = _line(smoke_root, "mla-smoke")
    assert line["correct"] is False


@pytest.mark.parametrize("cell", ["ssm-smoke", "mla-smoke"])
@pytest.mark.parametrize("seed", [4, 2**31 + 1])
def test_control_fails_the_limit(smoke_root, cell, seed):
    res, line = _line(smoke_root, cell, seed, control=True)
    for name, c in line["checks"].items():
        assert res["notes"]["control"][name] > c["limit"]
