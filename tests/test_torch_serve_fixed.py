"""The port's fixed-ring ``ServeEngine`` against the reference's, on the CPU.

* One trace through the port's ``ServeEngine`` and the reference's, with the
  reference's weights converted by ``repro_torch.convert``: qwen3-14b-smoke
  (dense), zamba2-7b-smoke (hybrid SSM) and gemma2-27b-smoke with one
  prompt past the smoke window of 64 (its ring keeps the trailing window;
  one unpadded prompt has no pad rows). More requests than slots, so slots
  are prefilled again over a finished request's rows. Contract: token
  streams equal up to the first near-tie (``tests/test_torch_engine.py``'s:
  where they first differ, the port's full-forward top-2 gap at that point
  is below ``_ULP_TIE``).
* The reference's ``tests/test_serve.py`` cases of ``ServeEngine`` compiled
  against the port through ``test_torch_cases._port_cases``: the engines
  built on the CPU, ``lm_init`` the reference's init converted.
* ``cuda``-marked: on the card, admission copies a prompt into the captured
  rings in place (every cache leaf keeps its ``data_ptr()`` across
  admissions) and the replayed engine's tokens equal the eager engine's.

JAX and the reference are imported inside the functions that use them, so
the ``cuda`` test runs on the card's machine with ``--noconftest``.
"""
import functools

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import get_config
from repro_torch.serve.engine import PagedServeEngine, Request, ServeEngine
from test_torch_cases import _port_cases

torch.set_num_threads(1)

def _engine_tests():
    """``tests/test_torch_engine.py``: its loader of the reference's smoke
    weights (converted) and its near-tie contract. It imports JAX, so the
    CPU tests import it where they use it."""
    import test_torch_engine
    return test_torch_engine


def _reference_backend():
    """The reference's backend on a memory-only compile cache."""
    from repro.core.backend import ArrayBackend
    from repro.core.compile_cache import CompileCache
    return ArrayBackend(cache=CompileCache(persistent=False))


# prompt lengths per arch: gemma2's second prompt (70) is past its smoke
# window of 64, so its ring holds the trailing 64 rows from prefill on
LENS = {"qwen3-14b": (6, 9, 12, 8), "zamba2-7b": (6, 9, 12, 8),
        "gemma2-27b": (6, 70, 12, 9)}


def _trace(cls, vocab, lens, max_new=5, seed=5):
    r = np.random.default_rng(seed)
    return [cls(rid=i, prompt=r.integers(1, vocab, n), max_new=max_new)
            for i, n in enumerate(lens)]


@pytest.mark.parametrize("arch", list(LENS))
def test_fixed_engine_matches_reference(arch):
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServeEngine as JServeEngine
    te = _engine_tests()
    jcfg, jp, cfg, params = te._load(arch)
    lens = LENS[arch]
    ref = _trace(JRequest, jcfg.vocab, lens)
    JServeEngine(jcfg, jp, slots=2, capacity=96,
                 backend=_reference_backend()).run(ref, max_steps=500)
    port = _trace(Request, cfg.vocab, lens)
    eng = ServeEngine(cfg, params, slots=2, capacity=96, device="cpu")
    stats = eng.run(port, max_steps=500)
    assert all(r.done for r in ref) and all(r.done for r in port)
    assert stats["admitted"] == stats["prefill_dispatches"] == len(lens)
    assert stats["compile_sources"]["step"] in ("compiled", "memory")
    assert {stats["compile_sources"][f"prefill_s{n}"] for n in lens} <= {
        "compiled", "memory"}
    te._assert_match_modulo_ties(cfg, params, [r.prompt for r in ref],
                                 [r.out for r in ref], [r.out for r in port])


def test_fixed_engine_rejects_an_encoder_config():
    cfg = get_config("whisper-base", smoke=True)
    from repro_torch.launch.serve import init_params
    with pytest.raises(ValueError, match="decoder-only"):
        ServeEngine(cfg, init_params(cfg, "cpu"), slots=2, capacity=32,
                    device="cpu")


def test_admission_writes_the_rings_in_place():
    """Every cache leaf keeps its storage through admissions, decode steps
    and a slot's re-admission (the captured step reads them at their
    addresses), and a slot's rows are the prompt's own prefill rows."""
    from repro_torch.launch.serve import init_params
    from repro_torch.models.lm import prefill
    cfg = get_config("qwen3-14b", smoke=True)
    params = init_params(cfg, "cpu")
    eng = ServeEngine(cfg, params, slots=2, capacity=32, device="cpu")
    ptrs = [x.data_ptr() for x in pytree.tree_leaves(eng.caches)]
    reqs = _trace(Request, cfg.vocab, (6, 9, 12), max_new=3)
    eng.run(reqs)
    assert [x.data_ptr() for x in pytree.tree_leaves(eng.caches)] == ptrs
    # a fresh admission into slot 0 holds exactly the prompt's prefill rows
    req = Request(rid=9, prompt=np.arange(1, 11), max_new=2)
    assert eng.admit(req) and eng.active[0] is req
    _, want = prefill(params, {"tokens": torch.arange(
        1, 11, dtype=torch.int32)[None]}, cfg, capacity=32)
    for got, w in zip(pytree.tree_leaves(eng.caches),
                      pytree.tree_leaves(want)):
        assert torch.equal(got[:, 0], w[:, 0])


# ---------------------------------------------------------------------------
# The reference's cases of ServeEngine, against the port
# ---------------------------------------------------------------------------

SERVE = ("test_engine_completes_requests", "test_engine_batches_share_steps",
         "test_paged_tokens_bit_identical_to_fixed",
         "test_paged_identity_across_cache_layouts",
         "test_stall_is_value_neutral_for_ssm_state",
         "test_overflow_guard_rejects_and_clamps")


def _converted_init(key, cfg):
    """The reference's ``lm_init(key, cfg)`` for the port's ``cfg``,
    converted to the port's tensors on the CPU."""
    import jax

    from repro.configs import get_config as jget
    from repro.models.lm import lm_init as jlm_init
    from repro_torch.convert import params_from_jax
    arch = cfg.name[:-len("-smoke")]
    jp = jlm_init(key, jget(arch, smoke=True))
    return params_from_jax(jax.tree.map(np.asarray, jp))


globals().update(_port_cases("test_serve.py", SERVE, "serve", overrides={
    "lm_init": _converted_init,
    "ServeEngine": functools.partial(ServeEngine, device="cpu"),
    "PagedServeEngine": functools.partial(PagedServeEngine, device="cpu")}))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-14b", "zamba2-7b",
                                  "deepseek-v2-236b"])
def test_cuda_fixed_engine_replays_over_rings_written_in_place(cuda_device,
                                                               arch):
    from repro_torch.core.backend import ArrayBackend
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.launch.serve import init_params
    cfg = get_config(arch, smoke=True)
    params = init_params(cfg, cuda_device)
    outs = {}
    for capture in (True, False):
        be = ArrayBackend(cache=CompileCache(persistent=False),
                          device=cuda_device)
        eng = ServeEngine(cfg, params, slots=2, capacity=48, backend=be,
                          device=cuda_device, capture_step=capture)
        ptrs = [x.data_ptr() for x in pytree.tree_leaves(eng.caches)]
        reqs = _trace(Request, cfg.vocab, (6, 9, 12, 8), max_new=6)
        stats = eng.run(reqs)
        assert all(r.done for r in reqs)
        assert [x.data_ptr() for x in pytree.tree_leaves(eng.caches)] == ptrs
        outs[capture] = [r.out for r in reqs]
        if capture:
            # the step and one prefill executable a prompt length, each
            # captured once and replayed after
            lens = len(stats["compile_sources"]) - 1
            assert set(stats["compile_sources"].values()) == {"compiled"}
            assert be.cache.stats["captures"] == 1 + lens
            assert be.cache.stats["replays"] == (
                stats["steps"] - 1 + stats["prefill_dispatches"] - lens)
    assert outs[True] == outs[False]


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["fixed", "paged"])
def test_serve_cli_runs_either_engine_on_the_cpu(engine, capsys):
    """``python -m repro_torch.launch.serve --engine ...`` through ``main``:
    the fixed engine prints the reference's lines (no pool line; the table
    titled ``<name> fixed``), the paged engine its pool line."""
    from repro_torch.launch import serve as serve_cli
    serve_cli.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                    "--engine", engine, "--requests", "3", "--slots", "2",
                    "--prompt-len", "8", "--gen-len", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests, 9 tokens" in out   # + 3 from prefill
    assert f"qwen3-14b-smoke {engine}" in out
    assert ("  pool: " in out) == (engine == "paged")
    assert "compile cache: step=" in out


def test_serve_cli_fails_without_a_card_unless_asked_for_the_cpu():
    from repro_torch.launch import serve as serve_cli
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        serve_cli.main(["--arch", "qwen3-14b", "--smoke", "--engine",
                        "fixed", "--requests", "1"])
