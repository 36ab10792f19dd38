"""The port's train step, checkpoints, restart loop and gradient compression
on the CPU at smoke width: ``train.step.make_train_step`` against the
reference's over three steps and against itself with two microbatches,
``ckpt.checkpoint`` across the two packages in both directions,
``runtime.fault.resilient_train`` against an uninterrupted run,
``runtime.compress`` against the reference's, and ``launch.train.train``.

Tolerances, each with a control that must fail it:
  * three train steps (mamba2-1.3b, qwen3-14b; converted reference params,
    lr 1e-3): each step's loss within 1e-3 of the reference's, and the
    parameters' change over the three steps within 0.2 of the reference's
    change in norm (bf16 gradients rounded at other points flip the sign of
    Adam's step on entries whose gradient is near zero: ~7% apart).
    Control: the labels shifted by one position (the change is then ~1.3
    of the reference's off).
  * microbatches 2 against 1, in f32: loss and gradient norm within 1e-6
    and 1e-5 relative, the parameters' change within 1e-3 in norm. Control:
    the second microbatch replaced by another batch.
  * checkpoints: keys, dtypes and values exact in both directions.
  * restart: exact (the CPU is deterministic), as the reference's
    ``tests/test_fault.py::test_restart_equals_uninterrupted``; control:
    the run without the restore (the lost steps skipped) differs.
  * compression: exact against the reference's quantize / dequantize and
    error feedback over three rounds; control: dropping the error feedback
    differs from the second round on.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs import get_config
from repro.data.pipeline import DataConfig, synth_batch
from repro.models import lm as jlm
from repro.runtime import compress as jcomp
from repro.train.optimizer import AdamWConfig as JAdamW
from repro.train.optimizer import adamw_init as j_adamw_init
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.core.backend import ArrayBackend
from repro_torch.launch.train import batch_fn, compile_step, train
from repro_torch.runtime import compress as tcomp
from repro_torch.runtime.fault import (FailureDetector, FaultConfig,
                                       HeartbeatDetector, HookDetector,
                                       WorkerFailure, resilient_train)
from repro_torch.models.blocks import tree_map
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         leaves_with_path)
from repro_torch.train.step import init_state, make_train_step

torch.set_num_threads(1)

LOSS_ATOL = 1e-3
CHANGE_RTOL = 0.2


def _flat(tree) -> dict:
    return {p: (np.asarray(x, np.float32) if not isinstance(x, torch.Tensor)
                else x.detach().float().numpy())
            for p, x in leaves_with_path(tree)}


def _change_excess(before: dict, got: dict, ref: dict) -> float:
    """|(got - before) - (ref - before)| / |ref - before| over all leaves."""
    num = sum(float(((got[k] - ref[k]) ** 2).sum()) for k in ref)
    den = sum(float(((ref[k] - before[k]) ** 2).sum()) for k in ref)
    return (num / den) ** 0.5


def _port_state(arch):
    """(reference cfg, reference state, port cfg, port state): the port's
    state converted from the reference's."""
    cfg = get_config(arch, smoke=True)
    jp = jlm.lm_init(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    return (cfg, {"params": jp, "opt": j_adamw_init(jp)},
            tget(arch, smoke=True), {"params": tp, "opt": adamw_init(tp)})


def _np_batches(cfg, n, seq=32, batch=4):
    dcfg = DataConfig(seq_len=seq, global_batch=batch)
    return [synth_batch(dcfg, s, cfg) for s in range(n)]


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "qwen3-14b"])
def test_three_train_steps_match_reference(arch):
    cfg, js, tcfg, ts = _port_state(arch)
    before = _flat(ts["params"])
    batches = _np_batches(cfg, 3)
    jstep = jax.jit(j_make_train_step(cfg, JAdamW(lr=1e-3, warmup_steps=0)))

    def port_run(shift):
        state = {"params": tree_map(torch.clone, ts["params"]),
                 "opt": adamw_init(ts["params"])}
        step = make_train_step(tcfg, AdamWConfig(lr=1e-3, warmup_steps=0))
        losses = []
        for nb in batches:
            b = {k: torch.from_numpy(v) for k, v in nb.items()}
            if shift:
                b["labels"] = torch.roll(b["labels"], 1, dims=1)
            out, m = step(state, b)
            assert out is state
            losses.append(float(m["loss"]))
        assert int(state["opt"]["step"]) == 3
        return losses, _flat(state["params"])

    j_losses = []
    for nb in batches:
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in nb.items()})
        j_losses.append(float(jm["loss"]))
    ref = _flat(js["params"])
    losses, got = port_run(shift=False)
    np.testing.assert_allclose(losses, j_losses, atol=LOSS_ATOL)
    assert _change_excess(before, got, ref) <= CHANGE_RTOL
    c_losses, c_got = port_run(shift=True)
    assert _change_excess(before, c_got, ref) > CHANGE_RTOL
    assert not np.allclose(c_losses, j_losses, atol=LOSS_ATOL)


def test_microbatches_two_equal_one_in_f32():
    cfg = tget("qwen3-14b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    p0 = tree_map(lambda p: p.float(), init_state(gen, cfg, "cpu")["params"])
    nb = _np_batches(cfg, 2, batch=4)
    batch = {k: torch.from_numpy(v) for k, v in nb[0].items()}
    other = {k: torch.cat([v[:2], torch.from_numpy(nb[1][k])[2:]])
             for k, v in batch.items()}
    opt = AdamWConfig(lr=1e-3, warmup_steps=0)

    def run(mb, b):
        state = {"params": tree_map(torch.clone, p0), "opt": adamw_init(p0)}
        _, m = make_train_step(cfg, opt, microbatches=mb)(state, b)
        return m, _flat(state["params"])

    m1, one = run(1, batch)
    m2, two = run(2, batch)
    before = _flat(p0)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-5)
    assert _change_excess(before, two, one) <= 1e-3
    mc, ctrl = run(2, other)
    assert abs(float(mc["loss"]) - float(m1["loss"])) > 1e-6 * float(
        m1["loss"])
    assert _change_excess(before, ctrl, one) > 1e-3


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------

def _filled_reference_state(arch):
    """A reference train state with every leaf non-trivial: moments and
    step drawn from a seed."""
    cfg, js, tcfg, ts = _port_state(arch)
    r = np.random.default_rng(1)
    opt = js["opt"]
    fill = lambda a: jnp.asarray(r.standard_normal(a.shape), a.dtype)
    js = {"params": js["params"],
          "opt": {"m": jax.tree.map(fill, opt["m"]),
                  "v": jax.tree.map(fill, opt["v"]),
                  "step": jnp.asarray(7, jnp.int32)}}
    return js, tcfg


def test_checkpoint_from_reference_restores_in_port(tmp_path):
    js, tcfg = _filled_reference_state("mamba2-1.3b")
    jckpt.save(str(tmp_path), 7, js, blocking=True)
    gen = torch.Generator().manual_seed(3)
    like = init_state(gen, tcfg, "cpu")
    ptrs = [x.data_ptr() for _, x in leaves_with_path(like)]
    dtypes = [x.dtype for _, x in leaves_with_path(like)]
    out, step = tckpt.restore(str(tmp_path), like=like)
    assert step == 7 and out is like
    assert [x.data_ptr() for _, x in leaves_with_path(like)] == ptrs
    assert [x.dtype for _, x in leaves_with_path(like)] == dtypes
    ref = _flat(js)
    got = _flat(like)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    assert int(like["opt"]["step"]) == 7


def test_checkpoint_from_port_restores_in_reference(tmp_path):
    js, tcfg = _filled_reference_state("olmoe-1b-7b")
    gen = torch.Generator().manual_seed(5)
    ts = init_state(gen, tcfg, "cpu")
    tree_map(lambda x: x.normal_(generator=gen), ts["opt"]["m"])
    ts["opt"]["step"].fill_(11)
    tckpt.save(str(tmp_path / "port"), 11, ts, blocking=True)
    jckpt.save(str(tmp_path / "ref"), 11, js, blocking=True)
    with open(tmp_path / "port" / "step_00000011" / "meta.json") as f:
        port_keys = __import__("json").load(f)["keys"]
    with open(tmp_path / "ref" / "step_00000011" / "meta.json") as f:
        ref_keys = __import__("json").load(f)["keys"]
    assert port_keys == ref_keys
    out, step = jckpt.restore(str(tmp_path / "port"), like=js)
    assert step == 11
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(out)[0],
            jax.tree_util.tree_flatten_with_path(js)[0]):
        assert a.dtype == b.dtype, pa
    got, want = _flat(out), _flat(ts)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_checkpoint_roundtrip_and_gc(tmp_path):
    gen = torch.Generator().manual_seed(0)
    state = init_state(gen, tget("mamba2-1.3b", smoke=True), "cpu")
    want = {k: v.copy() for k, v in _flat(state).items()}
    t = tckpt.save(str(tmp_path), 7, state, blocking=False)
    tree_map(lambda x: x.zero_(), state)       # the next step, mid-write
    t.join()
    restored, step = tckpt.restore(str(tmp_path), like=state)
    assert step == 7
    for k, v in _flat(restored).items():
        np.testing.assert_array_equal(v, want[k])
    for s in (1, 2, 3, 4, 5):
        tckpt.save(str(tmp_path / "gc"), s, state, blocking=True, keep=2)
    assert tckpt.latest_steps(str(tmp_path / "gc")) == [4, 5]


# ---------------------------------------------------------------------------
# Restart
# ---------------------------------------------------------------------------

def _setup(capture_step=True):
    cfg = tget("mamba2-1.3b", smoke=True)
    dcfg = DataConfig(seq_len=32, global_batch=4, vocab=cfg.vocab)
    gen = torch.Generator().manual_seed(0)
    state = init_state(gen, cfg, "cpu")
    get = batch_fn(cfg, dcfg, "cpu")
    step, source = compile_step(
        cfg, AdamWConfig(lr=1e-3, warmup_steps=0), state, get(0),
        backend=ArrayBackend(device="cpu"), capture_step=capture_step)
    return step, state, get, source


@pytest.mark.parametrize("async_save", [False, True])
def test_restart_equals_uninterrupted(tmp_path, async_save):
    n = 6
    step, ref, get, source = _setup()
    assert source in ("compiled", "memory")
    for s in range(n):
        ref, _ = step(ref, get(s))

    _, state0, _, _ = _setup()
    ptrs = [x.data_ptr() for _, x in leaves_with_path(state0)]
    fails = {"armed": True}

    def failure_hook(s):
        if s == 4 and fails["armed"]:
            fails["armed"] = False
            raise WorkerFailure("injected node loss")

    fcfg = FaultConfig(ckpt_dir=str(tmp_path / "ck"), ckpt_every=2,
                       async_save=async_save)
    out, report = resilient_train(step, state0, get, n, fcfg,
                                  failure_hook=failure_hook)
    assert report.restarts == 1 and report.restore_steps == [4]
    assert report.steps_run == n and len(report.losses) == n
    assert [x.data_ptr() for _, x in leaves_with_path(out)] == ptrs
    want = _flat(ref)
    for k, v in _flat(out).items():
        np.testing.assert_array_equal(v, want[k])

    # control: skipping the lost steps instead of restoring differs
    _, skip, _, _ = _setup(capture_step=False)
    for s in (0, 1, 2, 3, 5):
        skip, _ = step(skip, get(s))
    assert any(not np.array_equal(v, want[k])
               for k, v in _flat(skip).items())


def test_train_entry_point_on_cpu(tmp_path, monkeypatch):
    """``launch.train.train``: the step through the compile cache and
    eagerly give the same losses on the CPU, checkpoints land every
    ``ckpt_every`` steps, and without ``device`` it needs the card."""
    cfg = tget("qwen3-14b", smoke=True)
    kw = dict(steps=4, batch=2, seq=32, device="cpu", ckpt_every=2)
    _, rep_c, src_c = train(cfg, ckpt_dir=str(tmp_path / "c"), **kw)
    _, rep_e, src_e = train(cfg, ckpt_dir=str(tmp_path / "e"),
                            capture_step=False, **kw)
    assert src_c["step"] in ("compiled", "memory")
    assert src_e == {"step": "eager"}
    assert rep_c.losses == rep_e.losses and len(rep_c.losses) == 4
    assert all(np.isfinite(rep_c.losses))
    assert tckpt.latest_steps(str(tmp_path / "c")) == [0, 2, 4]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(cfg, steps=1, batch=2, seq=32, ckpt_dir=str(tmp_path / "x"))


def test_heartbeat_detector_reports_dead_worker_once():
    t = [0.0]
    det = HeartbeatDetector(timeout_s=1.0, clock=lambda: t[0])
    assert isinstance(det, FailureDetector)
    assert isinstance(HookDetector(lambda s: None), FailureDetector)
    det.beat("w0")
    det.beat("w1")
    det.check()
    t[0] = 0.9
    det.beat("w1")
    t[0] = 1.5
    assert det.stale() == ["w0"]
    assert det.age("w0") == pytest.approx(1.5)
    assert det.age("unknown") == float("inf")
    with pytest.raises(WorkerFailure, match="w0"):
        det.check(step=5)
    det.check()
    det.beat("w0")
    det.check()


def test_resilient_train_with_pluggable_detector(tmp_path):
    t = [0.0]
    det = HeartbeatDetector(timeout_s=10.0, clock=lambda: t[0])
    det.beat("node0")

    def step_fn(state, batch):
        state["x"].add_(1.0)
        return state, {}

    def batch_fn_(step):
        if step == 3:
            t[0] = 99.0
        return None

    fcfg = FaultConfig(ckpt_dir=str(tmp_path / "ck"), ckpt_every=2,
                       async_save=False)
    state, report = resilient_train(step_fn, {"x": torch.zeros(())},
                                    batch_fn_, 6, fcfg, detector=det)
    assert report.restarts == 1
    assert report.restore_steps == [4]
    assert float(state["x"]) == 6.0


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_matches_reference(dtype):
    r = np.random.default_rng(0)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    shapes = {"w_up": (16, 8), "groups": [{"A_log": (4,)}, {"wq": (3, 5)}]}
    rounds = [jax.tree.map(lambda s: jnp.asarray(
        r.standard_normal(s) * 0.01, jdt), shapes,
        is_leaf=lambda s: isinstance(s, tuple)) for _ in range(3)]
    j_err = jcomp.ef_init(rounds[0])
    t_err = tcomp.ef_init(params_from_jax(jax.tree.map(np.asarray,
                                                      rounds[0])))
    t_plain = tcomp.ef_init(params_from_jax(jax.tree.map(np.asarray,
                                                        rounds[0])))
    for i, g in enumerate(rounds):
        tg = params_from_jax(jax.tree.map(np.asarray, g))
        j_out, j_err = jcomp.compress_grads(g, j_err)
        t_out, t_err = tcomp.compress_grads(tg, t_err)
        p_out, _ = tcomp.compress_grads(tg, t_plain)   # no feedback
        want, got = _flat(j_out), _flat(t_out)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        for k, v in _flat(j_err).items():
            np.testing.assert_array_equal(_flat(t_err)[k], v)
        if i > 0:
            assert any(not np.array_equal(v, want[k])
                       for k, v in _flat(p_out).items())
    q, s = tcomp.quantize(torch.linspace(-3, 3, 256))
    assert q.dtype == torch.int8
    np.testing.assert_allclose(tcomp.dequantize(q, s).numpy(),
                               np.linspace(-3, 3, 256), atol=float(s) * 0.51)
