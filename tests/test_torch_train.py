"""The port's training loss and optimizer against the reference's, on the CPU
at smoke width: ``models.lm.lm_loss`` with every gradient leaf against
``jax.value_and_grad(lm_loss)``, ``train.optimizer.adamw_update`` and
``schedule`` against the reference's.

The reference's smoke params (``lm_init`` from PRNGKey(0)), converted with
``convert.params_from_jax``, go through both packages with one seeded
``synth_batch`` (embeds and frames rounded to bf16 on both sides, as the
port's input specs declare them). The reference is jitted, except for the
MoE configs (olmoe-1b-7b, deepseek-v2-236b), which it runs eagerly
(``jax.disable_jit()``): inside its scan, XLA's fusion flips near-tied
expert choices (``tests/test_torch_lm.py``'s docstring).

Tolerances, each with a control that must fail it:
  * loss: within LOSS_ATOL = 1e-3 (loss ~6.3; the packages round bf16
    activations at different points, ~3e-4 apart). Control on the MoE
    configs: the port's loss without its aux term (~0.05) must fail it.
  * gradients: every leaf within GRAD_RTOL = 0.05 of the leaf's largest
    reference entry plus GRAD_ATOL = 1e-4 (bf16 gradients summed in other
    orders: up to ~3.5% of a leaf's scale on qk-norm scales; the floor
    admits leaves whose true gradient is zero, e.g. whisper's key biases,
    where both packages return rounding noise of ~2e-5). Control: the
    port's gradients with the labels shifted by one position must fail it.
  * adamw_update: f32 params and moments within 1e-6 of each leaf's
    largest entry (the same op sequence, rounded at the same points; the
    bias corrections' powers differ by an ulp), bf16 params within one bf16
    rounding of it (2^-8). Controls: the reference without the clip, and
    without weight decay, must fail.
  * schedule: within 1e-6 relative at every step; control: the step off by
    one must fail.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.data.pipeline import DataConfig, synth_batch
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.models import lm as tlm
from repro_torch.models.blocks import tree_map
from repro_torch.train import optimizer as topt

torch.set_num_threads(1)

LOSS_ATOL = 1e-3
GRAD_RTOL, GRAD_ATOL = 0.05, 1e-4
ARCHS = ("qwen3-14b", "mamba2-1.3b", "olmoe-1b-7b", "deepseek-v2-236b",
         "whisper-base", "internvl2-76b")


def _is_moe(cfg):
    return any(b.moe is not None for g in cfg.groups for b in g.pattern)


def _batch(cfg, seq, batch=2, step=0):
    """One seeded synth_batch in both packages' tensors."""
    nb = synth_batch(DataConfig(seq_len=seq, global_batch=batch), step, cfg)
    jb = {k: (jnp.asarray(v, jnp.bfloat16) if v.dtype == np.float32
              else jnp.asarray(v)) for k, v in nb.items()}
    return jb, {k: tensor_from_numpy(np.asarray(v)) for k, v in jb.items()}


def _reference(cfg, jp, jb):
    """(loss, metrics, grads as {path: f32 array}) of the reference."""
    moe = _is_moe(cfg)
    f = jax.value_and_grad(
        lambda p, b: jlm.lm_loss(p, b, cfg, remat=False), has_aux=True)
    with jax.disable_jit() if moe else contextlib.nullcontext():
        (loss, metrics), grads = (f if moe else jax.jit(f))(jp, jb)
    flat = dict(topt.leaves_with_path(jax.tree.map(np.asarray, grads)))
    return float(loss), metrics, {k: np.asarray(v, np.float32)
                                  for k, v in flat.items()}


def _port(tcfg, params, tb, remat=True):
    """(loss, metrics, grads as {path: f32 array}) of the port."""
    tree = tree_map(lambda p: p.detach().requires_grad_(), params)
    paths, live = zip(*topt.leaves_with_path(tree))
    loss, metrics = tlm.lm_loss(tree, tb, tcfg, remat=remat)
    grads = torch.autograd.grad(loss, live)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (float(loss.detach()), metrics,
            {k: g.float().numpy() for k, g in zip(paths, grads)})


def _grad_excess(got: dict, ref: dict) -> tuple:
    """(largest error over its tolerance, that leaf's path): <= 1 passes."""
    worst = (0.0, None)
    for path, r in ref.items():
        tol = GRAD_RTOL * np.abs(r).max() + GRAD_ATOL
        e = float(np.abs(got[path] - r).max()) / tol
        worst = max(worst, (e, "/".join(map(str, path))))
    return worst


_LOADED = {}


def _load(arch):
    if arch not in _LOADED:
        cfg = get_config(arch, smoke=True)
        jp = jlm.lm_init(jax.random.PRNGKey(0), cfg)
        _LOADED[arch] = (cfg, jp, tget(arch, smoke=True),
                         params_from_jax(jax.tree.map(np.asarray, jp)))
    return _LOADED[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_match_reference(arch):
    cfg, jp, tcfg, tp = _load(arch)
    moe = _is_moe(cfg)
    jb, tb = _batch(cfg, seq=16 if moe else 32)
    j_loss, j_m, j_grads = _reference(cfg, jp, jb)
    t_loss, t_m, t_grads = _port(tcfg, tp, tb)
    assert np.isfinite(t_loss)
    assert abs(t_loss - j_loss) <= LOSS_ATOL, (t_loss, j_loss)
    assert abs(float(t_m["aux"]) - float(j_m["aux"])) <= LOSS_ATOL
    assert int(t_m["tokens"]) == int(j_m["tokens"])
    assert set(t_grads) == set(j_grads)
    excess, leaf = _grad_excess(t_grads, j_grads)
    assert excess <= 1.0, (excess, leaf)

    # controls: labels shifted by one must fail the gradient tolerance;
    # on MoE configs, the loss without its aux term must fail the loss's
    shifted = dict(tb, labels=torch.roll(tb["labels"], 1, dims=1))
    assert _grad_excess(_port(tcfg, tp, shifted)[2], j_grads)[0] > 1.0
    if moe:
        assert float(t_m["aux"]) > 0
        assert abs(t_loss - float(t_m["aux"]) - j_loss) > LOSS_ATOL


def test_chunked_loss_with_remat_matches_reference(monkeypatch):
    """Past one LOSS_CHUNK the loss is summed chunk by chunk (each chunk
    recomputed in the backward pass under remat): against the reference
    with the same chunk, and the port with and without remat."""
    monkeypatch.setattr(jlm, "LOSS_CHUNK", 16)
    monkeypatch.setattr(tlm, "LOSS_CHUNK", 16)
    cfg, jp, tcfg, tp = _load("qwen3-14b")
    jb, tb = _batch(cfg, seq=64)
    j_loss, _, j_grads = _reference(cfg, jp, jb)
    t_loss, t_m, t_grads = _port(tcfg, tp, tb)
    assert abs(t_loss - j_loss) <= LOSS_ATOL
    assert _grad_excess(t_grads, j_grads)[0] <= 1.0
    n_loss, _, n_grads = _port(tcfg, tp, tb, remat=False)
    assert n_loss == t_loss
    for k in t_grads:
        np.testing.assert_array_equal(n_grads[k], t_grads[k])
    assert _grad_excess(
        _port(tcfg, tp, dict(tb, labels=torch.roll(tb["labels"], 1, 1)))[2],
        j_grads)[0] > 1.0


def test_vlm_labels_pad_the_patch_positions():
    """internvl2's loss counts only the text labels: the patch embeddings'
    positions are padded with IGNORE, in both packages."""
    cfg, jp, tcfg, tp = _load("internvl2-76b")
    _, tb = _batch(cfg, seq=32)
    _, m = tlm.lm_loss(tp, tb, tcfg, remat=False)
    assert int(m["tokens"]) == int((tb["labels"] != tlm.IGNORE).sum())
    assert tb["tokens"].shape[1] == 32 - cfg.frontend_len


@pytest.mark.parametrize("window", [None, 5])
def test_blocked_attention_backward_matches_flat(window):
    """Training attends through ``attn_core``; past its threshold it takes
    the blocked online-softmax path, whose in-place score updates must
    leave autograd what it saved. In f32, with 8-key blocks over 20 keys:
    the blocked path's gradients equal the flat path's within 1e-5 of
    their scale; control: the flat path's with the window one key wider
    must fail that."""
    from repro_torch.models import attention as ta
    r = np.random.default_rng(0)
    B, S, K, G, D = 2, 20, 2, 2, 8
    q, k, v = (torch.from_numpy(r.standard_normal(s).astype(np.float32))
               for s in ((B, S, K * G, D), (B, S, K, D), (B, S, K, D)))
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    gout = torch.from_numpy(r.standard_normal((B, S, K * G, D)).astype(
        np.float32))

    def grads(path, win):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        out = path(ins[0].reshape(B, S, K, G, D), ins[1], ins[2], pos, pos,
                   scale=D ** -0.5, causal=True, window=win, cap=None)
        return torch.autograd.grad(out.reshape(B, S, K * G, D), ins, gout)

    orig = ta.KV_BLOCK
    ta.KV_BLOCK = 8
    try:
        got = grads(ta._attn_blocked, window)
    finally:
        ta.KV_BLOCK = orig
    want = grads(ta._attn_flat, window)
    ctrl = grads(ta._attn_flat, window + 1 if window else S - 3)

    def excess(a, b):
        return max(float((x - y).abs().max() / (1e-5 * y.abs().max()))
                   for x, y in zip(a, b))

    assert excess(got, want) <= 1.0
    assert excess(ctrl, want) > 1.0


# ---------------------------------------------------------------------------
# AdamW and the schedule
# ---------------------------------------------------------------------------

def _trees(dtype, seed=0):
    """A param tree whose keys take both sides of the decay mask, and three
    gradient trees large enough that the clip applies."""
    r = np.random.default_rng(seed)
    shapes = {"embed": {"embedding": (32, 8)}, "w_up": (8, 16),
              "norm_attn": {"scale": (16,)},
              "groups": [{"A_log": (4,), "conv_bias_x": (4,)},
                         {"wq": (4, 8), "q_norm": (8,)}]}

    def draw(scale):
        return jax.tree.map(lambda s: (r.standard_normal(s) * scale).astype(
            np.float32), shapes, is_leaf=lambda s: isinstance(s, tuple))

    p = draw(0.5)
    gs = [draw(1.0) for _ in range(3)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p)
    jgs = [jax.tree.map(lambda a: jnp.asarray(a, jdt), g) for g in gs]
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    tgs = [params_from_jax(jax.tree.map(np.asarray, g)) for g in jgs]
    return jp, jgs, tp, tgs


def _run_reference(cfg, jp, jgs):
    st = jopt.adamw_init(jp)
    for g in jgs:
        jp, st, m = jopt.adamw_update(cfg, jp, g, st)
    return jp, st, m


def _close(tree_t, tree_j, rtol):
    """Every leaf within ``rtol`` of its largest reference entry."""
    ref = dict(topt.leaves_with_path(jax.tree.map(np.asarray, tree_j)))
    for path, t in topt.leaves_with_path(tree_t):
        r = np.asarray(ref[path], np.float32)
        if np.abs(t.float().numpy() - r).max() > rtol * np.abs(r).max():
            return False
    return True


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    cfg = jopt.AdamWConfig(lr=5e-2, warmup_steps=2, total_steps=10)
    tcfg = topt.AdamWConfig(**cfg.__dict__)
    jp, jgs, tp, tgs = _trees(dtype)
    j_p, j_st, j_m = _run_reference(cfg, jp, jgs)

    t_st = topt.adamw_init(tp)
    ids = [id(x) for _, x in topt.leaves_with_path(tp)]
    for g in tgs:
        t_p, t_st2, t_m = topt.adamw_update(tcfg, tp, g, t_st)
        assert t_p is tp and t_st2 is t_st               # in place
    assert [id(x) for _, x in topt.leaves_with_path(tp)] == ids
    assert int(t_st["step"]) == int(j_st["step"]) == 3
    assert float(t_m["grad_norm"]) > tcfg.grad_clip      # the clip applied
    np.testing.assert_allclose(float(t_m["grad_norm"]),
                               float(j_m["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(t_m["lr"]), float(j_m["lr"]), rtol=1e-6)
    p_rtol = 2 ** -8 if dtype == "bfloat16" else 1e-6
    assert _close(tp, j_p, p_rtol)
    assert _close(t_st["m"], j_st["m"], 1e-6)
    assert _close(t_st["v"], j_st["v"], 1e-6)

    # controls: the reference without the clip, or without weight decay,
    # must fail the params' tolerance
    for change in (dict(grad_clip=1e9), dict(weight_decay=0.0)):
        other = jopt.AdamWConfig(**{**cfg.__dict__, **change})
        assert not _close(tp, _run_reference(other, jp, jgs)[0], p_rtol)


def test_decay_mask_reads_the_reference_key_paths():
    for path in (("groups", 0, "stacked", "0", "attn", "wq"),
                 ("embed", "embedding"), ("lm_head", "lm_head"),
                 ("groups", 1, "stacked", "0", "moe", "we_up")):
        assert topt._decay_mask(path)
    for path in (("final_norm", "scale"), ("groups", 0, "stacked", "0",
                                           "ssm", "A_log"),
                 ("groups", 0, "stacked", "0", "ssm", "D"),
                 ("groups", 0, "stacked", "0", "attn", "q_norm"),
                 ("groups", 0, "stacked", "0", "mlp", "b_up")):
        assert not topt._decay_mask(path)


def test_schedule_matches_reference():
    cfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=100, total_steps=1000,
                           min_lr_frac=0.1)
    tcfg = topt.AdamWConfig(**cfg.__dict__)
    steps = np.arange(0, 1201, 7, dtype=np.int32)
    ref = np.array([float(jopt.schedule(cfg, jnp.asarray(s))) for s in steps])
    got = topt.schedule(tcfg, torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-12)
    assert got.dtype == np.float32
    off = topt.schedule(tcfg, torch.from_numpy(steps + 1)).numpy()
    assert not np.allclose(off, ref, rtol=1e-6, atol=1e-12)
