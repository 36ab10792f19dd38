"""What a captured decode step needs of the model, and the compile cache's
executables.

* The pool write has no host sync and drops rows without touching a real
  page: ``_paged_leaf_update`` sends a dropped row (a -1 table entry, a pad
  position, a stalled slot) to the leaf's sink page. Held against the
  reference's write (``repro.models.attention._paged_leaf_update``, whose
  out-of-range index P drops the row) with a kept row at (page 0, offset 0)
  and dropped rows whose clamped index is the same place.
* Every pool write of the served families is in place: each pool leaf keeps
  its ``data_ptr()`` through ``paged_prefill``, ``paged_decode_step``,
  ``paged_clear`` and ``paged_copy`` (a graph reads the addresses it was
  captured with).
* ``live`` all true computes bit for bit what ``live=None`` does (the
  engine always passes a static ``live``).
* ``compile_cache``: the CPU executable's signature check, the lazy
  per-signature executable, the launch-counter bookkeeping of a replay.
* ``cuda``-marked: the captured step against the eager one on the card,
  the backends' launches on the card against numpy, the array job's rate
  against the serial baseline's, the serial submit against its execution.

No JAX at module level: the ``cuda`` tests run on the card's machine with
``--noconftest``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import compile_cache as cc
from repro_torch.launch.serve import init_params
from repro_torch.models import lm as tlm
from repro_torch.models.attention import _paged_leaf_update

torch.set_num_threads(1)

# the families the paged engine serves (whisper's encoder-decoder is not)
SERVED = ("qwen3-14b", "gemma2-27b", "gemma3-12b", "stablelm-12b",
          "olmoe-1b-7b", "mamba2-1.3b", "zamba2-7b", "deepseek-v2-236b",
          "internvl2-76b")
_PARAMS = {}


def _model(arch, device="cpu"):
    key = (arch, str(device))
    if key not in _PARAMS:
        cfg = get_config(arch, smoke=True)
        _PARAMS[key] = cfg, init_params(cfg, device)
    return _PARAMS[key]


def _leaves(pool):
    return [(gi, bi, kind, k, t) for gi, g in enumerate(pool)
            for bi, b in g.items() for kind, sub in b.items()
            for k, t in sub.items()]


# ---------------------------------------------------------------------------
# The sync-free pool write
# ---------------------------------------------------------------------------

def _write_problem():
    """P = 4 pages of 4 rows (K = 1, D = 2). Slot 0 keeps rows at (page 0,
    offsets 0 and 1); slot 1 is stalled (its table blanked to -1) at
    positions 0 and 1 — its clamped index is page 0 again; slot 2 maps
    page 0 too (a shared page) with a pad row (position -1) whose clamped
    index is (page 0, offset 0), and a kept row at position 6 (page 3,
    offset 2)."""
    r = np.random.default_rng(0)
    P, ps = 4, 4
    cache = {"k": r.standard_normal((P, ps, 1, 2)).astype(np.float32),
             "v": r.standard_normal((P, ps, 1, 2)).astype(np.float32),
             "pos": np.full((P, ps), -1, np.int32),
             "table": np.array([[0, 1], [-1, -1], [0, 3]], np.int32)}
    positions = np.array([[0, 1], [0, 1], [-1, 6]], np.int32)
    entries = {"k": r.standard_normal((3, 2, 1, 2)).astype(np.float32),
               "v": r.standard_normal((3, 2, 1, 2)).astype(np.float32)}
    return cache, entries, positions


@pytest.mark.parametrize("sink", ["standalone", "pool"])
def test_paged_leaf_update_drops_rows_without_touching_real_pages(sink):
    """Every real page ends bit-identical to the reference's write, the
    kept rows land, and the dropped rows (stalled slot, pad row) land only
    in the sink. ``standalone``: a leaf made outside any pool gets its sink
    page in place; ``pool``: a pool leaf seen through ``_paged_view``."""
    import jax.numpy as jnp
    from repro.models.attention import _paged_leaf_update as j_update
    cache, entries, positions = _write_problem()
    want = j_update({k: jnp.asarray(v) for k, v in cache.items()},
                    {k: jnp.asarray(v) for k, v in entries.items()},
                    jnp.asarray(positions))
    if sink == "standalone":
        t = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
        leaf = t
    else:
        full = {k: torch.from_numpy(np.concatenate(
            [v, np.full((1,) + v.shape[1:], 7, v.dtype)]))[None]
            for k, v in cache.items() if k != "table"}
        pool = {k: f[:, :4] for k, f in full.items()}      # P pages shown
        view = tlm._paged_view([{"0": {"attn": pool}}],
                               torch.from_numpy(cache["table"]))
        leaf = {**{k: v[0] for k, v in view[0]["0"]["attn"].items()
                   if k in ("k", "v", "pos")},
                "table": view[0]["0"]["attn"]["table"], "sink": True}
    ptr = {k: leaf[k].data_ptr() for k in ("k", "v", "pos")}
    out = _paged_leaf_update(leaf, {k: torch.from_numpy(v)
                                    for k, v in entries.items()},
                             torch.from_numpy(positions))
    for k in ("k", "v", "pos"):
        assert out[k].shape == cache[k].shape
        assert np.array_equal(out[k].numpy(), np.asarray(want[k])), k
    # the kept rows landed
    assert out["pos"][0, 0] == 0 and out["pos"][0, 1] == 1
    assert out["pos"][3, 2] == 6
    assert torch.equal(out["k"][0, 0], torch.from_numpy(entries["k"][0, 0]))
    assert torch.equal(out["k"][3, 2], torch.from_numpy(entries["k"][2, 1]))
    if sink == "pool":
        # in place, and the dropped rows went to the sink page (page 4)
        assert all(leaf[k].data_ptr() == ptr[k] for k in ptr)
        assert set(full["pos"][0, 4].tolist()) <= {7, -1, 0, 1}
        assert torch.equal(full["pos"][0, :4], out["pos"])


def test_paged_leaf_update_is_sync_free():
    """No ``nonzero``: the write's index tensors keep their shapes (B, S)
    whatever the data says, so nothing is read back to the host."""
    cache, entries, positions = _write_problem()
    t = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    calls = []
    orig = torch.Tensor.nonzero

    def spy(self, *a, **kw):
        calls.append(1)
        return orig(self, *a, **kw)

    torch.Tensor.nonzero = spy
    try:
        _paged_leaf_update(t, {k: torch.from_numpy(v)
                               for k, v in entries.items()},
                           torch.from_numpy(positions))
        tlm.paged_scatter([{"0": {"attn": {
            "k": t["k"][None], "v": t["v"][None], "pos": t["pos"][None]}}}],
            [{"0": {"attn": {"k": torch.zeros(1, 3, 8, 1, 2),
                             "v": torch.zeros(1, 3, 8, 1, 2),
                             "pos": torch.full((1, 3, 8), -1,
                                               dtype=torch.int32)}}}],
            torch.from_numpy(cache["table"]),
            torch.zeros((3, 1), dtype=torch.int32))
    finally:
        torch.Tensor.nonzero = orig
    assert not calls


def test_pool_without_sink_inside_capture_raises(monkeypatch):
    """A pool leaf that has no sink page is given one only outside a
    capture (it allocates); inside one, the write raises."""
    from repro_torch.models.attention import with_sink
    leaf = torch.zeros(4, 2, 3)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda s: True))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="sink"):
        with_sink(leaf)


# ---------------------------------------------------------------------------
# In-place pool writes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["gather", "paged"])
@pytest.mark.parametrize("arch", SERVED)
def test_pool_writes_keep_every_leaf_in_place(arch, kernel):
    cfg, params = _model(arch)
    B, P, ps, npps = 2, 12, 4, 6
    pool = tlm.paged_cache_init(cfg, B, P, ps, "cpu")
    before = [(k, t.data_ptr(), t.shape) for *_, k, t in _leaves(pool)]
    tables = torch.arange(B * npps, dtype=torch.int32).reshape(B, npps)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab, (B, 8)).astype(np.int32))
    lens = torch.tensor([8, 8], dtype=torch.int32)
    lg, out = tlm.paged_prefill(params, pool, tables, toks, lens, cfg,
                                kernel=kernel)
    out = tlm.paged_decode_step(params, out, tables,
                                torch.argmax(lg[:, 0], -1)[:, None].to(
                                    torch.int32),
                                lens[:, None].clone(), cfg, kernel=kernel)[1]
    out = tlm.paged_clear(out, [1, 2])
    out = tlm.paged_copy(out, [0], [5])
    after = [(k, t.data_ptr(), t.shape) for *_, k, t in _leaves(out)]
    assert after == before
    assert [(k, t.data_ptr()) for *_, k, t in _leaves(pool)] == [
        (k, p) for k, p, _ in before]


@pytest.mark.parametrize("arch", SERVED)
def test_live_all_true_equals_live_none(arch):
    """The engine passes ``live`` on every step (all true when nothing is
    stalled): bit for bit what ``live=None`` computes, logits and pool."""
    cfg, params = _model(arch)
    B, P, ps, npps = 2, 12, 4, 6
    tables = torch.arange(B * npps, dtype=torch.int32).reshape(B, npps)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        1, cfg.vocab, (B, 8)).astype(np.int32))
    lens = torch.tensor([8, 8], dtype=torch.int32)
    runs = []
    for live in (None, torch.ones(B, dtype=torch.bool)):
        pool = tlm.paged_cache_init(cfg, B, P, ps, "cpu")
        lg, pool = tlm.paged_prefill(params, pool, tables, toks, lens, cfg,
                                     kernel="paged")
        t = torch.argmax(lg[:, 0], -1)[:, None].to(torch.int32)
        lg2, pool = tlm.paged_decode_step(params, pool, tables, t,
                                          lens[:, None].clone(), cfg,
                                          live=live, kernel="paged")
        runs.append((lg2, [x for *_, x in _leaves(pool)]))
    (a, pa), (b, pb) = runs
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))


# ---------------------------------------------------------------------------
# The compile cache's executables
# ---------------------------------------------------------------------------

def test_cpu_executable_checks_the_signature():
    cache = cc.CompileCache()
    exe, src = cache.compile(lambda x, y: x + y,
                             (torch.zeros(3), cc.TensorSpec((3,),
                                                            torch.float32)),
                             device="cpu")
    assert src == "compiled" and isinstance(exe, cc.Executable)
    assert torch.equal(exe(torch.ones(3), torch.ones(3)), torch.full((3,), 2.))
    with pytest.raises(TypeError):
        exe(torch.ones(4), torch.ones(4))
    with pytest.raises(TypeError):
        exe(torch.ones(3, dtype=torch.int32), torch.ones(3))


def test_lazy_graph_makes_one_executable_per_signature():
    calls = []

    def fn(x):
        calls.append(tuple(x.shape))
        return x * 2

    lazy = cc.LazyGraph(fn, "cpu")
    for n in (3, 3, 5):
        assert torch.equal(lazy(torch.ones(n)), torch.full((n,), 2.))
    assert len(lazy._by_sig) == 2 and calls == [(3,), (3,), (5,)]


def test_replay_adds_the_captured_launch_counts():
    """A capture's change to a kernel's counters is taken back out (the
    capture launched nothing) and added on every replay."""
    from repro_torch.kernels.paged_attention import paged_attention
    saved = paged_attention.launches, dict(paged_attention.routes)
    try:
        before = cc._counts()
        paged_attention.launches += 3
        paged_attention.routes["split"] += 3
        delta = cc._count_delta(before, cc._counts())
        cc._apply_counts(delta, sign=-1)
        assert cc._counts() == before
        for _ in range(2):
            cc._apply_counts(delta)
        assert paged_attention.launches == saved[0] + 6
        assert paged_attention.routes["split"] == saved[1]["split"] + 6
    finally:
        paged_attention.launches = saved[0]
        paged_attention.routes = saved[1]


def test_engine_step_goes_through_the_cache_and_eager_on_request():
    from repro_torch.core.backend import ArrayBackend
    from repro_torch.serve.engine import PagedServeEngine, Request
    cfg, params = _model("qwen3-14b")
    cache = cc.CompileCache()
    outs = {}
    for capture in (True, False):
        eng = PagedServeEngine(cfg, params, slots=2, page_size=4,
                               pages_per_slot=8, device="cpu",
                               capture_step=capture,
                               backend=ArrayBackend(cache=cache,
                                                    device="cpu"))
        reqs = [Request(rid=i, prompt=np.arange(1, 7 + i), max_new=4)
                for i in range(3)]
        eng.run(reqs)
        outs[capture] = [r.out for r in reqs]
        want = "compiled" if capture else "eager"
        assert eng.stats["compile_sources"]["step"] == want
    assert outs[True] == outs[False]
    assert cache.stats["misses"] == 1


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
@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-1.3b", "zamba2-7b",
                                  "deepseek-v2-236b"])
def test_cuda_captured_step_equals_eager(cuda_device, arch):
    """The engine's captured decode step against the same step run
    eagerly, from one pool state: logits bit-equal on every replay."""
    from repro_torch.core.backend import ArrayBackend
    cfg, params = _model(arch, cuda_device)
    B, P, ps, npps = 2, 12, 16, 6
    tables = torch.arange(B * npps, dtype=torch.int32,
                          device=cuda_device).reshape(B, npps)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab, (B, 16)).astype(np.int32)).to(cuda_device)
    lens = torch.tensor([16, 16], dtype=torch.int32, device=cuda_device)
    pools = []
    for _ in range(2):
        pool = tlm.paged_cache_init(cfg, B, P, ps, cuda_device)
        lg, pool = tlm.paged_prefill(params, pool, tables, toks, lens, cfg,
                                     kernel="paged")
        pools.append(pool)

    def step(p, kv, tb, t, po, live):
        return tlm.paged_decode_step(p, kv, tb, t, po, cfg, live=live,
                                     kernel="paged")[0]

    live = torch.ones(B, dtype=torch.bool, device=cuda_device)
    t = torch.argmax(lg[:, 0], -1)[:, None].to(torch.int32)
    pos = lens[:, None].clone()
    exe, _ = ArrayBackend(cache=cc.CompileCache()).compile(
        step, (params, pools[1], tables, t, pos, live), bind_argnums=(0, 1))
    for i in range(4):
        eager = step(params, pools[0], tables, t, pos, live)
        graph = exe(params, pools[1], tables, t, pos, live).clone()
        assert torch.equal(eager, graph), i
        t = torch.argmax(eager[:, 0], -1)[:, None].to(torch.int32)
        pos = pos + 1
    assert exe.replays == 3


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["serial", "array", "pipelined"])
def test_cuda_backends_match_numpy(cuda_device, kind):
    from repro_torch.core.llmr import LLMapReduce
    x = np.random.default_rng(5).standard_normal((512, 64)).astype(
        np.float32)
    n = 64 if kind == "serial" else 512
    out, _ = LLMapReduce(scheduler=kind, wave_size=128,
                         cache=None if kind == "serial" else cc.CompileCache()
                         ).map_reduce(lambda v: (v * v).sum(), x[:n])
    got = torch.stack(out) if isinstance(out, list) else out
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), (x[:n] ** 2).sum(-1),
                               rtol=1e-5)


def _launch_app(x):
    return (x * 2.0).sum(axis=-1)


@pytest.mark.cuda
def test_cuda_launch_rate_array_beats_serial(cuda_device):
    """The paper's headline property on the card: a warm array launch
    beats the serial VM baseline (a capture per instance) by a wide
    margin."""
    import time
    from repro_torch.core.backend import SerialBackend
    from repro_torch.core.llmr import LLMapReduce
    inputs = np.ones((64, 8), np.float32)
    cache = cc.CompileCache()
    LLMapReduce(scheduler="array", cache=cache).map_reduce(_launch_app,
                                                           inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    LLMapReduce(scheduler="array", cache=cache).map_reduce(_launch_app,
                                                           inputs)
    torch.cuda.synchronize()
    t_array = time.perf_counter() - t0
    t0 = time.perf_counter()
    SerialBackend().launch(_launch_app, inputs, 64)
    t_serial = time.perf_counter() - t0
    assert t_serial > 3.0 * t_array, (t_serial, t_array)


@pytest.mark.cuda
def test_cuda_serial_submit_dwarfs_execution(cuda_device):
    """The serial baseline's per-task submit (a new executable: warm-up
    and capture) is under t_schedule and dwarfs the rest of the loop."""
    from repro_torch.core.backend import SerialBackend
    _, rec = SerialBackend().launch(_launch_app, np.ones((6, 4), np.float32),
                                    6)
    assert rec.total == pytest.approx(
        rec.t_schedule + rec.t_stage + rec.t_spawn)
    assert rec.t_schedule > rec.t_spawn
