"""The SPMD runtime (``repro_torch.sharding.spmd``) on the CPU: sharded
tensors on a mesh of ranks behind ``constrain`` / ``place`` /
``reshard_state`` / ``restore(sharding=)``, its collective counter, and the
dry run's collective term, against the reference.

* (a) Transitions on a (2, 4) mesh, counted under ``counting`` (a fake
  process group, ``meta`` tensors): a shard gathered, a shard moved from
  one dim to another, and a product over a cut contracting dim reduced to
  whole or to a cut. The ``CollectiveCounter``'s kind, count and operand
  bytes a rank equal the reference's ``parse_collectives`` of the same
  transition jitted with ``with_sharding_constraint`` on 8 host devices
  (a subprocess; Auto axes: ``jax.make_mesh`` now makes Explicit ones,
  which ``with_sharding_constraint`` refuses).
* (b) Whole cells at smoke width on the (2, 4) mesh: the dry run's
  collective bytes a chip (``dryrun.count_cell``, in a subprocess beside
  the reference's) against the reference's
  trip-weighted ``analyze(hlo).collective_bytes`` of its ``build_cell``,
  less the collectives of boolean masks (``pred[...]``: XLA gathers an
  attention mask over a cut sequence where the port builds each rank's
  mask from the replicated positions; at long_500k that gather is 97% of
  the reference's bytes). qwen3-14b and mamba2-1.3b at decode_32k and
  prefill_32k within a factor of 2 either way; every other cell both
  complete within a factor of 8 (XLA picks all-to-alls and permutes where
  DTensor gathers). Both breakdowns are printed.
* (c) Numerics: one spawned run of 4 gloo ranks on a (2, 2) mesh, in
  f32, shared by its cases (a module fixture; each rank runs one torch
  thread): prefill, decode_step and one train step (loss, and the params
  after AdamW) of qwen3-14b, mamba2-1.3b (the SSD scan's plain version on
  each rank's heads or rows) and olmoe-1b-7b at smoke width, each within
  2e-5 of the scale (the largest magnitude of the tensor, or of the whole
  param tree) of the unsharded port run and of the JAX reference's
  unsharded run. On each rank the live count equals the count of the same
  step under ``counting``. A 1-rank checkpoint restored onto the mesh
  (``restore(sharding=)`` into ``meta`` shapes, and ``reshard_state``)
  continues the unsharded losses; ``delivered_bytes`` of a sharded pull is
  the sum of every rank's shards.
"""
import json
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import spmd_ranks as R
from repro.configs import get_config as jget
from repro.models import lm as jlm
from repro.train.optimizer import AdamWConfig as JAdamW
from repro.train.optimizer import adamw_init as j_adamw_init
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import SHAPES_BY_NAME, cell_applicable
from repro_torch.configs import get_config as tget
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm as tlm
from repro_torch.sharding.partition import P, NamedSharding, place
from repro_torch.sharding.spmd import (CollectiveCounter, counting, einsum,
                                       spawn)
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.step import make_train_step

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-5
B, S = 4, 64
MESH24 = ((2, 4), ("data", "model"))

# (a): name -> (input specs, output spec, whether it is a product)
TRANSITIONS = {
    "shard_to_whole": ([("data", None)], (None, None), False),
    "shard_dim_to_dim": ([(None, "model")], ("model", None), False),
    "partial_to_whole": ([(None, "model"), ("model", None)], (None, None),
                         True),
    "partial_to_shard": ([(None, "model"), ("model", None)], ("model", None),
                         True),
}
# (b)
TIGHT = [(a, s) for a in ("qwen3-14b", "mamba2-1.3b")
         for s in ("decode_32k", "prefill_32k")]
LOOSE = [(a, s) for a in ("zamba2-7b", "internvl2-76b", "gemma3-12b",
                          "gemma2-27b", "stablelm-12b", "whisper-base",
                          "olmoe-1b-7b", "deepseek-v2-236b", "qwen3-14b",
                          "mamba2-1.3b")
         for s in ("decode_32k", "prefill_32k", "long_500k")
         if (a, s) not in TIGHT and cell_applicable(a, SHAPES_BY_NAME[s])[0]]
LOOSE += [("mamba2-1.3b", "train_4k"), ("qwen3-14b", "train_4k")]

REFERENCE = r'''
import json, os, re, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import SHAPES_BY_NAME
from repro.launch.dryrun import build_cell
from repro.launch.hlo_analysis import analyze
from repro.launch.roofline import parse_collectives
req = json.loads(sys.argv[1])
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {"transitions": {}, "cells": {}}
for name, (ins, to, prod) in req["transitions"].items():
    shapes = [(16, 32), (32, 8)][:len(ins)]
    def f(*xs, to=to, prod=prod):
        y = xs[0] @ xs[1] if prod else xs[0]
        return jax.lax.with_sharding_constraint(
            y, NamedSharding(mesh, P(*to)))
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    shs = tuple(NamedSharding(mesh, P(*i)) for i in ins)
    hlo = jax.jit(f, in_shardings=shs).lower(*args).compile().as_text()
    st, hc = parse_collectives(hlo), analyze(hlo)
    out["transitions"][name] = [
        {k: [st.count_by_kind[k], v] for k, v in st.bytes_by_kind.items()},
        {k: [hc.count_by_kind[k], v] for k, v in hc.bytes_by_kind.items()}]
MASK = re.compile(r"=\s*\S*pred\[[^=]*\b(all-gather|all-reduce|"
                  r"reduce-scatter|all-to-all|collective-permute)")
for arch, shape in req["cells"]:
    try:
        jitted, args, _ = build_cell(arch, SHAPES_BY_NAME[shape], mesh,
                                     smoke=True)
        hlo = jitted.lower(*args).compile().as_text()
        kept = "\n".join(l for l in hlo.splitlines() if not MASK.search(l))
        hc = analyze(kept)
        out["cells"][arch + "/" + shape] = [hc.collective_bytes,
                                            hc.bytes_by_kind]
    except Exception as e:  # a cell the reference cannot compile
        out["cells"][arch + "/" + shape] = [None, repr(e)[:200]]
print("JSON" + json.dumps(out))
'''


PORT = r'''
import json, sys
import torch
from repro_torch.configs import SHAPES_BY_NAME
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
torch.set_num_threads(1)
out = {}
for arch, shape in json.loads(sys.argv[1])["cells"]:
    _, coll, _, _ = dryrun.count_cell(arch, SHAPES_BY_NAME[shape],
                                      Mesh.abstract((2, 4), ("data", "model")),
                                      smoke=True)
    out[arch + "/" + shape] = [coll.total_bytes, coll.table()]
print("JSON" + json.dumps(out))
'''


def _start(script):
    """Start ``script`` in a subprocess on the cells and transitions of
    (a) and (b); returns a function that waits for its JSON."""
    req = {"transitions": TRANSITIONS, "cells": TIGHT + LOOSE}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", script, json.dumps(req)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def wait():
        out, err = proc.communicate(timeout=600)
        line = [l for l in out.splitlines() if l.startswith("JSON")]
        assert proc.returncode == 0 and line, err[-3000:]
        return json.loads(line[-1][4:])
    return wait


def _np(tree):
    """jax leaves -> numpy, floats widened to f32."""
    def one(a):
        a = np.asarray(a)
        return a.astype(np.float32) if np.issubdtype(
            a.dtype, np.floating) or a.dtype == ml_dtypes.bfloat16 else a
    return jax.tree.map(one, tree)


def _data(tmp):
    """Seeded inputs of the three archs (reference params widened to f32),
    the decode caches of the port's unsharded prefill (f32) and a 1-rank
    checkpoint of one qwen3 train step."""
    data = {}
    for i, arch in enumerate(R.ARCHS):
        cfg = jget(arch, smoke=True)
        params = _np(jlm.lm_init(jax.random.PRNGKey(i), cfg))
        r = np.random.default_rng(10 + i)
        tok = r.integers(1, cfg.vocab, (B, S)).astype(np.int32)
        d = {"params": params, "tokens": tok,
             "labels": r.integers(1, cfg.vocab, (B, S)).astype(np.int32),
             "step_tokens": r.integers(1, cfg.vocab, (B, 1)).astype(np.int32),
             "step_pos": np.full((B, 1), S, np.int32)}
        _, caches = tlm.prefill(R._tensors(params, "cpu"),
                                {"tokens": torch.from_numpy(tok)},
                                tget(arch, smoke=True), capacity=S + 4)
        d["caches"] = pytree.tree_map(
            lambda t: (t.float() if t.is_floating_point() else t).numpy(),
            caches)
        data[arch] = d
    arch = "qwen3-14b"
    p = R._tensors(data[arch]["params"], "cpu")
    state = {"params": p, "opt": adamw_init(p)}
    batch = {k: torch.from_numpy(data[arch][k]) for k in ("tokens", "labels")}
    step = make_train_step(tget(arch, smoke=True), AdamWConfig())
    state, _ = step(state, batch)
    data["ckpt_dir"] = str(tmp / "ckpt")
    ckpt.save(data["ckpt_dir"], 1, state)
    _, m = step(state, batch)
    data["continue_loss"] = float(m["loss"])
    return data


def _jax_runs(data):
    """The reference's unsharded f32 prefill, decode_step and train step."""
    out = {}
    for arch in R.ARCHS:
        cfg = jget(arch, smoke=True)
        d = data[arch]
        jp = jax.tree.map(jnp.asarray, d["params"])
        tok = jnp.asarray(d["tokens"])
        # the reference's prefill writes its bf16 rings with f32 rows, which
        # its dynamic_update_slice refuses: its last-token logits are
        # taken from the same forward without rings, and its decode step
        # reads the port's f32 rings (the same tree)
        logits = jax.jit(lambda p, t: jlm.lm_logits(
            p, jlm.lm_hidden(p, {"tokens": t}, cfg)[0][:, -1:], cfg))(jp, tok)
        out[arch, "prefill"] = {"logits": np.asarray(logits, np.float32)}
        caches = jax.tree.map(jnp.asarray, d["caches"])
        logits, _ = jax.jit(lambda p, c, t, q: jlm.decode_step(
            p, c, t, q, cfg))(jp, caches, jnp.asarray(d["step_tokens"]),
                              jnp.asarray(d["step_pos"]))
        out[arch, "decode"] = {"logits": np.asarray(logits, np.float32)}
        step = jax.jit(j_make_train_step(cfg, JAdamW()))
        state, m = step({"params": jp, "opt": j_adamw_init(jp)},
                        {"tokens": tok, "labels": jnp.asarray(d["labels"])})
        out[arch, "train"] = {"loss": np.asarray(m["loss"], np.float32),
                              "grad_norm": np.asarray(m["grad_norm"],
                                                      np.float32),
                              "params": _np(state["params"])}
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's counts and the port's dry-run counts of (b) (two
    subprocesses), the 4-rank gloo run (a thread waiting on the spawned
    ranks), the reference's and the port's unsharded runs, all at once."""
    tmp = tmp_path_factory.mktemp("spmd")
    reference, counted = _start(REFERENCE), _start(PORT)
    data = _data(tmp)
    with open(tmp / "data.pkl", "wb") as f:
        pickle.dump(data, f)
    failed = []

    def ranks():
        try:
            spawn(R.rank_main, 4, str(tmp / "data.pkl"), str(tmp),
                  device="cpu")
        except Exception as e:  # noqa: BLE001 — raised in the test below
            failed.append(e)

    th = threading.Thread(target=ranks)
    th.start()
    jax_out = _jax_runs(data)
    port = {(a, m): R.run(a, m, data, None)[0]
            for a in R.ARCHS for m in R.MODES}
    th.join()
    assert not failed, failed
    got = [pickle.load(open(tmp / f"rank{r}.pkl", "rb")) for r in range(4)]
    return {"data": data, "jax": jax_out, "port": port, "ranks": got,
            "reference": reference(), "counted": counted()}


def _scale_err(got, want):
    """The largest difference over the largest magnitude of ``want``: one
    tensor, or a train result (the loss and the gradient norm relative,
    the params after AdamW over the largest magnitude of the whole tree)."""
    if "logits" in want:
        return float(np.abs(got["logits"] - want["logits"]).max()
                     / np.abs(want["logits"]).max())
    g = pytree.tree_leaves(got["params"])
    w = pytree.tree_leaves(want["params"])
    scale = max(float(np.abs(x).max()) for x in w)
    diff = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
               for a, b in zip(g, w))
    rel = [abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
           for k in ("loss", "grad_norm")]
    return max(*rel, diff / scale)


# --- (a) transitions ---------------------------------------------------------

def _port_transition(name):
    ins, to, prod = TRANSITIONS[name]
    with counting(Mesh.abstract(*MESH24)) as m:
        xs = [place(torch.empty(s, device="meta"), NamedSharding(m, P(*i)))
              for s, i in zip([(16, 32), (32, 8)], ins)]
        with CollectiveCounter() as cc:
            y = einsum("ik,kn->in", *xs) if prod else xs[0]
            place(y, NamedSharding(m, P(*to)))
    return cc.stats.table()


def _operand_bytes(parsed, analyzed):
    """The reference's operand bytes by kind: ``analyze`` resolves each
    operand's shape by name (``parse_collectives`` reads inline operand
    types and, where the HLO prints none, takes the result's: an
    all-gather's gathered tensor), but for an all-to-all, whose tuple
    operand ``analyze`` does not resolve (0 B) and whose types are
    inline."""
    return {k: [int(v) for v in (parsed if k == "all-to-all"
                                 else analyzed)[k]]
            for k in set(parsed) | set(analyzed)}


@pytest.mark.parametrize("name", list(TRANSITIONS))
def test_a_transition_counts_equal_the_references(run, name):
    got = _port_transition(name)
    want = _operand_bytes(*run["reference"]["transitions"][name])
    print(name, "port", got, "reference", want)
    if name == "partial_to_shard":
        # XLA on the CPU lowers the reduce-scatter as an all-reduce and a
        # slice: the same operand bytes, another kind
        assert got == {"reduce-scatter": [1, 512]}
        assert want == {"all-reduce": [1, 512]}
        return
    assert got == want


# --- (b) whole cells ---------------------------------------------------------

def _cell_ratio(run, arch, shape):
    got, table = run["counted"][f"{arch}/{shape}"]
    want, kinds = run["reference"]["cells"][f"{arch}/{shape}"]
    print(arch, shape, "port", got, table, "reference", want, kinds)
    assert want, kinds
    assert got > 0
    return got / want


@pytest.mark.parametrize("arch,shape", TIGHT)
def test_b_cell_bytes_within_2x_of_the_references(run, arch, shape):
    r = _cell_ratio(run, arch, shape)
    assert 0.5 <= r <= 2.0, r


@pytest.mark.parametrize("arch,shape", LOOSE)
def test_b_cell_bytes_within_8x_of_the_references(run, arch, shape):
    r = _cell_ratio(run, arch, shape)
    assert 1 / 8 <= r <= 8, r


# --- (c) numerics ------------------------------------------------------------

CASES = [(a, m) for a in R.ARCHS for m in R.MODES]


@pytest.mark.parametrize("arch,mode", CASES)
def test_c_sharded_matches_the_unsharded_port(run, arch, mode):
    err = _scale_err(run["ranks"][0]["out"][arch, mode],
                     run["port"][arch, mode])
    assert err <= TOL, err


@pytest.mark.parametrize("arch,mode", CASES)
def test_c_sharded_matches_the_reference(run, arch, mode):
    err = _scale_err(run["ranks"][0]["out"][arch, mode],
                     run["jax"][arch, mode])
    assert err <= TOL, err


@pytest.mark.parametrize("arch,mode", CASES)
def test_c_live_count_equals_the_counted(run, arch, mode):
    for r, res in enumerate(run["ranks"]):
        assert res["live"][arch, mode] == res["counted"][arch, mode], r
    assert sum(n for _, n in run["ranks"][0]["live"][arch, mode].values())


def test_c_every_rank_has_the_same_outputs(run):
    for res in run["ranks"][1:]:
        for case in CASES:
            assert _scale_err(res["out"][case],
                              run["ranks"][0]["out"][case]) == 0.0


def test_c_restore_and_reshard_continue_the_losses(run):
    want = run["data"]["continue_loss"]
    for res in run["ranks"]:
        for loss in res["continue"]:
            assert abs(loss - want) <= TOL * abs(want), (loss, want)


def test_c_delivered_bytes_is_the_sum_of_the_shards(run):
    delivered, shards, total = run["ranks"][0]["pull"]
    # w (64, 8) f32 cut over all four ranks, b (8,) bf16 on every rank
    assert delivered == shards == total == 64 * 8 * 4 + 4 * 8 * 2


def test_c_ranks_ran_single_threaded(run):
    assert all(res["threads"] == 1 for res in run["ranks"])


# --- one rank ----------------------------------------------------------------

@pytest.mark.parametrize("arch", R.ARCHS)
def test_one_rank_is_bit_equal_to_the_unsharded_step(arch):
    """A mesh of one rank (this process, gloo) leaves every tensor whole:
    prefill and decode_step logits bit-equal to the same steps with no
    mesh, in the model's bf16, and no collective."""
    from repro_torch.sharding.partition import (batch_sharding,
                                                cache_sharding,
                                                param_sharding, sharding_ctx)
    from repro_torch.sharding.spmd import shutdown, spmd_mesh
    cfg = tget(arch, smoke=True)
    params = tlm.lm_init(torch.Generator().manual_seed(0), cfg, "cpu")
    r = np.random.default_rng(3)
    tok = torch.from_numpy(r.integers(1, cfg.vocab, (B, S)).astype(np.int32))
    step = {"tokens": torch.from_numpy(
        r.integers(1, cfg.vocab, (B, 1)).astype(np.int32)),
        "positions": torch.full((B, 1), S, dtype=torch.int32)}
    want, rings = tlm.prefill(params, {"tokens": tok}, cfg, capacity=S + 4)
    copy = pytree.tree_map(torch.clone, rings)
    want_d, _ = tlm.decode_step(params, rings, step["tokens"],
                                step["positions"], cfg)
    mesh = spmd_mesh((1,), ("model",), device="cpu")
    try:
        def put(tree, shardings, mode):
            return pytree.tree_map(place, tree, shardings(tree, mesh, mode))
        with CollectiveCounter() as cc:
            with sharding_ctx(mesh, "prefill"):
                got, _ = tlm.prefill(put(params, param_sharding, "prefill"),
                                     put({"tokens": tok}, batch_sharding,
                                         "prefill"), cfg, capacity=S + 4)
            inp = put(step, batch_sharding, "serve")
            with sharding_ctx(mesh, "serve"):
                got_d, _ = tlm.decode_step(
                    put(params, param_sharding, "serve"),
                    put(copy, cache_sharding, "serve"), inp["tokens"],
                    inp["positions"], cfg)
        assert torch.equal(got.full_tensor(), want)
        assert torch.equal(got_d.full_tensor(), want_d)
        assert cc.stats.table() == {}
    finally:
        shutdown()


def test_recompute_runs_under_the_forward_sharding_context():
    """On the card autograd runs the backward pass in a thread of its own,
    where the thread-local sharding context is unset: a checkpointed
    block's recompute must still see the mesh its forward saw (else its
    ``constrain`` calls do nothing and the layouts change)."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.sharding.partition import (current_mesh,
                                                recompute_context,
                                                sharding_ctx)
    mesh = Mesh.abstract((2,), ("data",))
    seen = []

    def body(x):
        seen.append(current_mesh())
        return x * x                    # saves x: the backward recomputes

    x = torch.ones(3, requires_grad=True)
    with sharding_ctx(mesh, "train"):
        y = checkpoint(body, x, use_reentrant=False,
                       context_fn=recompute_context)
    th = threading.Thread(target=lambda: y.sum().backward())
    th.start()
    th.join()
    assert seen == [mesh, mesh] and x.grad.tolist() == [2.0] * 3


@pytest.mark.parametrize("mode,shape", [("train", "train_4k"),
                                        ("prefill", "prefill_32k"),
                                        ("decode", "decode_32k")])
def test_wine_apps_on_a_mesh_of_one_rank(mode, shape):
    """``WineAdapter(mesh=spmd_mesh(...))``: the app's state laid out on the
    mesh, compiled through the compile cache ("compiled" source: on the
    CPU the executable is the step itself behind its signature, which
    holds the state's layout), its outputs bit-equal to the same app's on
    the CPU without a mesh (mamba2-1.3b, smoke width)."""
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.core.wine import WineAdapter, WineApp
    from repro_torch.sharding.spmd import shutdown, spmd_mesh
    app = WineApp("mamba2-1.3b", mode=mode, shape=shape, smoke=True)

    def batch(adapter):
        r = np.random.default_rng(4)
        return {k: torch.from_numpy(r.integers(1, 64, v.shape).astype(
                    np.int32)) if v.dtype == torch.int32
                else torch.zeros(v.shape, dtype=v.dtype)
                for k, v in adapter.input_specs(app).items()}

    plain = WineAdapter(device="cpu", cache=CompileCache(persistent=False))
    want = plain.load(app).run(batch(plain))
    mesh = spmd_mesh((1,), ("model",), device="cpu")
    try:
        adapter = WineAdapter(mesh=mesh, device="cpu",
                              cache=CompileCache(persistent=False))
        inst = adapter.load(app)
        got = inst.run(batch(adapter))
        assert inst.load_report["compile_source"] == "compiled"
        assert inst.step_fn.sharded and inst.step_fn.calls == 1
        leaves = pytree.tree_leaves(got)
        assert leaves and all(
            torch.equal(g.full_tensor() if hasattr(g, "full_tensor") else g,
                        w) for g, w in zip(leaves, pytree.tree_leaves(want)))
    finally:
        shutdown()


def test_paged_and_flash_kernels_refuse_sharded_inputs():
    """Neither kernel is on a sharded path: a DTensor raises, naming why,
    rather than taking the plain version on a gathered copy."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.sharding.spmd import as_sharded
    with counting(Mesh.abstract((2,), ("model",))) as m:
        q = place(torch.empty(2, 4, 8, 16, device="meta"),
                  NamedSharding(m, P(None, "model", None, None)))
        kv = as_sharded(torch.empty(2, 4, 8, 16, device="meta"), q)
        with pytest.raises(NotImplementedError, match="no model calls it"):
            flash_attention(q, kv, kv)
        with pytest.raises(NotImplementedError, match="one device"):
            paged_attention(q, kv, kv, torch.zeros(4, 8, dtype=torch.int32),
                            torch.zeros(2, 2, dtype=torch.int32),
                            torch.zeros(2, 4, dtype=torch.int32))


# --- the ring write on a cut ring ---------------------------------------------

RING = (4, 16, 2, 3)               # slots, rows a slot, kv heads, head dim
RING_CASES = {"decode": (1, [5, 0, 15, 9]),        # S, each slot's position
              "prefill": (6, [0, 3, 20, 0]),
              "longer_than_the_ring": (20, [0, 7, 0, 30])}


def _ring_write(cache, S, first):
    from repro_torch.models.attention import _ring_update
    r = np.random.default_rng(S)
    new = {"k": torch.from_numpy(
        r.standard_normal((RING[0], S) + RING[2:]).astype(np.float32))}
    pos = torch.tensor(first, dtype=torch.int32)[:, None] + torch.arange(
        S, dtype=torch.int32)[None]
    return _ring_update(cache, new, pos)


def _sentinel_ring():
    """A ring whose every entry is a sentinel: k -9, pos -7."""
    return {"k": torch.full(RING, -9.0),
            "pos": torch.full(RING[:2], -7, dtype=torch.int32)}


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_write_on_a_cut_ring_is_the_plain_write(case, rank):
    """``spmd.write_rows`` (a ring cut along its slots over ``data`` and
    its rows over ``model``, seen as rank ``rank`` of a fake (2, 2) mesh)
    leaves each rank's shard as the plain ring write leaves that part of
    the whole ring: a one-token decode, a prefill shorter than the ring
    and one longer (a roll). Every other row keeps its sentinel."""
    from torch.distributed.tensor import Shard

    from repro_torch.sharding.spmd import shard_of
    S, first = RING_CASES[case]
    want = _ring_write(_sentinel_ring(), S, first)
    with counting(Mesh.abstract((2, 2), ("data", "model")), rank=rank) as m:
        pl = (Shard(0), Shard(1))
        cut = {k: shard_of(v, m.device_mesh, pl, "cpu")
               for k, v in _sentinel_ring().items()}
        got = _ring_write(cut, S, first)
        for k in want:
            assert torch.equal(
                got[k].to_local(),
                shard_of(want[k], m.device_mesh, pl, "cpu").to_local()), k


@pytest.mark.parametrize("rank", range(4))
def test_ring_write_with_no_start_fills_the_first_rows(rank):
    """``write_rows`` with no start (MLA's prefill write) puts the S new
    rows at rows 0..S-1 of every slot of a cut ring, as ``ring[:, :S] =
    rows`` does."""
    from torch.distributed.tensor import Shard

    from repro_torch.sharding.spmd import shard_of, write_rows
    rows = torch.arange(4 * 10 * 3, dtype=torch.float32).reshape(4, 10, 3)
    want = torch.full((4, 16, 3), -9.0)
    want[:, :10] = rows
    with counting(Mesh.abstract((2, 2), ("data", "model")), rank=rank) as m:
        pl = (Shard(0), Shard(1))
        leaf = shard_of(torch.full((4, 16, 3), -9.0), m.device_mesh, pl,
                        "cpu")
        write_rows(leaf, rows)
        assert torch.equal(leaf.to_local(), shard_of(
            want, m.device_mesh, pl, "cpu").to_local())


def test_a_one_token_write_on_a_cut_ring_touches_only_its_rows():
    """A decode step's ring write on a cut ring is B x S rows of work a
    rank, as the plain path's ``index_put``: no op it runs (views and
    in-place writes aside) makes a tensor of more than the batch's new
    rows, whatever the ring's length."""
    from torch.distributed.tensor import Shard
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.sharding.spmd import shard_of, write_rows

    class Sizes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.made = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not (func.is_view or func._schema.is_mutable):
                self.made += [(t.numel(), str(func))
                              for t in pytree.tree_leaves(out)
                              if isinstance(t, torch.Tensor)]
            return out

    B_, cap, K, D = 4, 4096, 2, 8
    with counting(Mesh.abstract((2, 2), ("data", "model")), rank=3) as m:
        leaf = shard_of(torch.full((B_, cap, K, D), -9.0), m.device_mesh,
                        (Shard(0), Shard(1)), "cpu")
        rows = torch.ones(B_, 1, K, D)
        start = torch.tensor([5, 2100, 4095, 3000])
        with Sizes() as sizes:
            write_rows(leaf, rows, start)
    lo = leaf.to_local()
    assert max(sizes.made)[0] <= rows.numel(), max(sizes.made)
    # rank 3 holds slots 2-3 and rows 2048-4095: slot 2 is written at 4095,
    # slot 3 at 3000, nothing else
    written = (lo != -9.0).all(-1).all(-1).nonzero().tolist()
    assert written == [[0, 4095 - 2048], [1, 3000 - 2048]]


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("n", [16, 7, 5, 2])
def test_shard_offset_is_torchs(n, rank):
    """``spmd._offset`` (from the sizes alone) is the global offset torch
    gives each rank's shard, for even and uneven cuts of a dim by one mesh
    dim or by both."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    from repro_torch.sharding.spmd import _offset, shard_of
    with counting(Mesh.abstract((2, 2), ("data", "model")), rank=rank) as m:
        for pl in ((Shard(0), Shard(0)), (Shard(1), Shard(0)),
                   (Replicate(), Shard(0)), (Shard(0), Shard(1))):
            x = shard_of(torch.zeros(n, 3), m.device_mesh, pl, "cpu")
            _, off = compute_local_shape_and_global_offset(
                x.shape, m.device_mesh, pl)
            assert [_offset(x, d) for d in (0, 1)] == list(off), pl
