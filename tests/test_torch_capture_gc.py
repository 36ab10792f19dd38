"""A CUDA graph capture runs with Python's cyclic garbage collector off.

A graph destroyed in the capturing thread invalidates the capture, and the
collector frees a dropped fabric's or engine's graphs in whatever thread
it happens to run (``chip_smoke.py``'s ``[dist]`` gates once failed so: a
closed fabric's graphs were collected inside a thread node's capture).
``GraphExecutable`` therefore turns the collector off from
``capture_begin`` to ``capture_end`` and back on after, also when the
capture fails. These tests run its Python on the CPU with the card's
graph, streams and cache faked; no JAX, no card.
"""
import contextlib
import gc

import pytest
import torch

from repro_torch.core import compile_cache as cc


class _Stream:
    def wait_stream(self, other):
        pass


class _FakeGraph:
    """Records whether the collector was on at capture begin and end."""
    seen = []

    def capture_begin(self, pool=None, capture_error_mode=None):
        _FakeGraph.seen.append(("begin", gc.isenabled()))

    def capture_end(self):
        _FakeGraph.seen.append(("end", gc.isenabled()))

    def replay(self):
        pass


@pytest.fixture
def fake_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(cc, "capture_stream", lambda device: _Stream())
    _FakeGraph.seen = []
    yield
    gc.enable()


def _executable(fn):
    x = torch.ones(3)
    return cc.GraphExecutable(fn, cc._signature((x,)), device="cpu"), x


def test_no_collection_inside_a_capture(fake_card):
    """The warm-up runs with the collector on, the capture with it off;
    it is on again after, and replays leave it alone."""
    during = []

    def fn(x):
        during.append(gc.isenabled())
        return x * 2

    exe, x = _executable(fn)
    torch.testing.assert_close(exe(x), x * 2)
    assert during == [True, False]
    assert _FakeGraph.seen == [("begin", False), ("end", False)]
    assert gc.isenabled()
    exe(x)
    assert exe.stats == {"captures": 1, "t_capture_s": pytest.approx(
        exe.stats["t_capture_s"]), "replays": 1}
    assert gc.isenabled()


def test_a_failed_capture_turns_collection_back_on(fake_card):
    """A function that raises inside the capture: the call raises (no
    eager fallback) and the collector is on again."""
    calls = []

    def fn(x):
        calls.append(gc.isenabled())
        if len(calls) == 2:
            raise RuntimeError("refused inside the capture")
        return x

    exe, x = _executable(fn)
    with pytest.raises(RuntimeError, match="no eager fallback"):
        exe(x)
    assert calls == [True, False]
    assert gc.isenabled()


def test_collection_left_off_where_the_caller_turned_it_off(fake_card):
    gc.disable()
    exe, x = _executable(lambda x: x + 1)
    exe(x)
    assert not gc.isenabled()
