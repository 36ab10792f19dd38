"""The sharded step compiled once, on the CPU: DTensor arguments in the
compile cache (``repro_torch.core.compile_cache``) and the Wine apps of a
mesh of ranks loaded through it (``WineAdapter(mesh=spmd_mesh(...))``).

* Keys and signatures: a DTensor argument is keyed and checked by its
  layout (the mesh's sizes and axis names, placements, local shape). The
  same global shape laid out otherwise, on another mesh, or whole gets
  another key and signature, and an executable refuses it.
* Records: the signature of a sharded ``prefill`` app (on ``meta`` under
  ``spmd.counting``) round-trips through ``signature_record`` (as JSON) and
  ``record_args``, placements and all.
* The replay's count: ``count_replayed`` adds a captured record to every
  ``CollectiveCounter`` open in the thread and takes it back out.
* The Wine apps on a (2, 2) mesh of four gloo ranks (one spawned run
  shared by its cases; each rank one torch thread): qwen3-14b and
  mamba2-1.3b at smoke width, in the train, prefill and decode modes, each
  loaded from the reference's params. Every app's source is "compiled"
  (never "eager"), its outputs and the state it leaves are bit-equal to
  the same step run eagerly on the SPMD runtime (``spmd_ranks._eager_wine``
  lays the state and the batch out and runs the step), and the
  executable's ``collectives`` equal what that eager step issued. The
  logits are within ``LOGIT_ATOL`` = 3e-2, the loss within
  ``TRAIN_LOSS_ATOL`` = 1e-3 and the gradient norm within 1e-2 relative
  of the reference's Wine apps on the same inputs
  (``tests/test_torch_wine.py``'s limits), run in a subprocess on an
  Auto-axis (2, 2) mesh of four host devices, as
  ``tests/test_torch_spmd.py`` runs the reference (nothing in the
  reference changed). A second adapter over a rank's record directory
  loads every app from "disk", and the mamba2 prefill's record reads back
  its executable's signature. ``spmd.settle`` waits a pending collective
  (an asynchronous redistribution's local tensor).
"""
import json
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import spmd_ranks as R
from repro.configs import get_config as jget
from repro.models import lm as jlm
from repro_torch.configs import get_config as tget
from repro_torch.configs import input_specs
from repro_torch.core.compile_cache import (_signature, fingerprint,
                                            make_executable, record_args,
                                            signature_record)
from repro_torch.core.wine import WineAdapter
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.roofline import CollectiveStats
from repro_torch.sharding.spmd import (CollectiveCounter, ShardedSpec,
                                       count_replayed, counting, shard_of,
                                       spawn, spec_of)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LOGIT_ATOL = 3e-2
TRAIN_LOSS_ATOL = 1e-3
GRAD_NORM_RTOL = 1e-2
APPS = [(a, m) for a in R.WINE_ARCHS for m in R.MODES]

REFERENCE = r'''
import json, os, pickle, sys
# four host devices on one thread: the rank processes beside it run one
# torch thread each, and other test files share the machine
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.core.compile_cache import CompileCache
from repro.core.wine import WineAdapter, WineApp
from repro.models import lm
from repro.train.optimizer import adamw_init
data = pickle.load(open(sys.argv[1], "rb"))
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
ad = WineAdapter(mesh=mesh, cache=CompileCache(persistent=False))
out = {}
for arch, shapes in data["apps"]:
    cfg = get_config(arch, smoke=True)
    params = jax.tree.map(jnp.asarray, data[arch]["params"])
    for mode, shape in shapes:
        app = WineApp(arch=arch, mode=mode, shape=shape, smoke=True)
        cell = ad._cell(app)
        state = ({"params": params, "opt": adamw_init(params)}
                 if mode == "train" else params if mode == "prefill"
                 else (params, lm.cache_init(cfg, cell.global_batch,
                                             cell.seq_len)))
        inst = ad.load(app, state=state)
        got = inst.run({k: jnp.asarray(v)
                        for k, v in data[arch]["batches"][mode].items()})
        rec = {"source": inst.load_report["compile_source"]}
        if mode == "train":
            rec.update(loss=float(got["loss"]),
                       grad_norm=float(got["grad_norm"]))
        else:
            rec["logits"] = np.asarray(got[0] if mode == "prefill" else got,
                                       np.float32).tolist()
        out[arch + "/" + mode] = rec
print("JSON" + json.dumps(out))
'''


def _data():
    """The reference's smoke params of each arch (``lm_init`` from
    PRNGKey(i), numpy) and a seeded whole batch of each app (decode at
    position 3 of zero rings)."""
    data = {"apps": [(a, [(m, R.WINE_SHAPES[m]) for m in R.MODES])
                     for a in R.WINE_ARCHS]}
    for i, arch in enumerate(R.WINE_ARCHS):
        cfg = jget(arch, smoke=True)
        params = jax.tree.map(np.asarray, jlm.lm_init(jax.random.PRNGKey(i),
                                                     cfg))
        r = np.random.default_rng(5 + i)
        batches = {}
        for mode in R.MODES:
            specs = input_specs(tget(arch, smoke=True),
                                WineAdapter._cell(R.wine_app(arch, mode)))
            batches[mode] = {
                k: np.full(v.shape, 3, np.int32) if k == "positions"
                else r.integers(1, cfg.vocab, v.shape).astype(np.int32)
                for k, v in specs.items()}
        data[arch] = {"params": params, "batches": batches}
    return data


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's Wine apps on its Auto mesh (a subprocess) and the
    four gloo ranks (a thread waiting on them), at once."""
    tmp = tmp_path_factory.mktemp("spmd-graph")
    data = _data()
    with open(tmp / "data.pkl", "wb") as f:
        pickle.dump(data, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE,
                            str(tmp / "data.pkl")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    failed = []

    def ranks():
        try:
            spawn(R.wine_rank_main, 4, str(tmp / "data.pkl"), str(tmp),
                  device="cpu")
        except Exception as e:  # noqa: BLE001 — raised in the test below
            failed.append(e)

    th = threading.Thread(target=ranks)
    th.start()
    out, err = ref.communicate(timeout=600)
    th.join()
    assert not failed, failed
    line = [l for l in out.splitlines() if l.startswith("JSON")]
    assert ref.returncode == 0 and line, err[-3000:]
    got = [pickle.load(open(tmp / f"wine-rank{r}.pkl", "rb"))
           for r in range(4)]
    return {"ranks": got, "reference": json.loads(line[-1][4:])}


# --- keys and signatures -------------------------------------------------------

def _layouts(sizes, placements):
    """(fingerprint, signature, whether an executable of it refuses the
    reference layout's tensor (None: no such tensor on this mesh), whether
    it is sharded) of an (8, 16) tensor laid out as ``placements`` on an
    abstract mesh of ``sizes`` (None: whole), as rank 0 sees it."""
    from torch.distributed.tensor import Replicate, Shard

    def fn(x):
        return x * 2

    names = ("data", "model")[-len(sizes):]
    pl = {"S0": Shard(0), "S1": Shard(1), "R": Replicate()}
    with counting(Mesh.abstract(sizes, names)) as m:
        ref = shard_of(torch.zeros(8, 16), m.device_mesh,
                       (Shard(0), Replicate()), "cpu") if len(sizes) == 2 \
            else None
        x = (torch.zeros(8, 16) if placements is None else shard_of(
            torch.zeros(8, 16), m.device_mesh,
            tuple(pl[p] for p in placements), "cpu"))
        exe = make_executable(fn, (x,), device="cpu")
        refused = None
        if ref is not None and x is not ref:
            try:
                exe(ref)
                refused = False
            except TypeError:
                refused = True
        return (fingerprint(fn, (x,), device="cpu"), _signature((x,)),
                refused, exe.sharded)


@pytest.mark.parametrize("other", [
    ((2, 2), ("R", "S1")),          # the same mesh, other placements
    ((2, 2), ("S0", "S1")),         # cut once more
    ((4,), ("S0",)),                # another mesh, the same rows a rank
    ((2, 2), None),                 # whole
])
def test_key_and_signature_carry_the_layout(other):
    """An (8, 16) tensor cut along its rows over ``data`` of a (2, 2) mesh
    against the same global shape laid out otherwise: another key, another
    signature, and an executable of the other layout refuses it."""
    key, sig, _, sharded = _layouts((2, 2), ("S0", "R"))
    okey, osig, refused, osharded = _layouts(*other)
    assert sharded and osharded == (other[1] is not None)
    assert key != okey and sig != osig
    if refused is not None:
        assert refused
    assert _layouts((2, 2), ("S0", "R"))[:2] == (key, sig)


def test_sharded_prefill_record_round_trips():
    """A sharded prefill app's arguments (mamba2-1.3b's params laid out for
    prefill on a (2, 2) mesh, on ``meta``, and the app's whole batch specs)
    through ``signature_record``, JSON and ``record_args``: the same
    signature and key, with each leaf's placements."""
    from torch.distributed.tensor import Shard

    from repro_torch.models import lm
    from repro_torch.sharding.partition import param_sharding, place
    cfg = tget("mamba2-1.3b", smoke=True)
    app = R.wine_app("mamba2-1.3b", "prefill")
    specs = input_specs(cfg, WineAdapter._cell(app))

    def fn(params, inputs):
        return inputs

    with counting(Mesh.abstract((2, 2), ("data", "model")), rank=3) as m:
        params = lm.lm_init(None, cfg, "meta")
        params = pytree.tree_map(place, params,
                                 param_sharding(params, m, "prefill"))
        args = (params, specs)
        rec = json.loads(json.dumps({"signature": signature_record(args)}))
        back = record_args(rec)
        assert _signature(back) == _signature(args)
        assert fingerprint(fn, back, device="cpu") == fingerprint(
            fn, args, device="cpu")
    leaves = [x for x in pytree.tree_leaves(back) if isinstance(x,
                                                               ShardedSpec)]
    assert len(leaves) == len(pytree.tree_leaves(params))
    assert all(s.mesh_sizes == (2, 2) and s.axis_names == ("data", "model")
               for s in leaves)
    assert any(isinstance(p, Shard) for s in leaves for p in s.placements)
    assert [spec_of(x) for x in pytree.tree_leaves(back[1])] == [None] * len(
        specs)


def test_a_replay_counts_in_every_open_counter():
    """``count_replayed`` adds a captured record to every counter open in
    the thread (nested ones too) and, with ``sign=-1``, takes it back out,
    leaving no kind at zero."""
    rec = CollectiveStats()
    rec.add("all-reduce", 64)
    rec.add("all-gather", 32)
    with CollectiveCounter() as outer:
        with CollectiveCounter() as inner:
            count_replayed(rec)
            count_replayed(rec)
        assert inner.stats.table() == {"all-reduce": [2, 128],
                                       "all-gather": [2, 64]}
        count_replayed(rec, sign=-1)
    assert outer.stats.table() == {"all-reduce": [1, 64],
                                   "all-gather": [1, 32]}
    count_replayed(rec)                 # no counter open: nothing to add
    outer.stats.merge(rec, sign=-1)
    assert outer.stats.table() == {}


# --- the Wine apps on a (2, 2) mesh of gloo ranks ---------------------------

@pytest.mark.parametrize("arch,mode", APPS)
def test_wine_app_on_a_mesh_of_ranks_is_compiled(run, arch, mode):
    for res in run["ranks"]:
        app = res["apps"][arch, mode]
        assert app["source"] == "compiled" and app["sharded"]
        assert app["calls"] == 1


@pytest.mark.parametrize("arch,mode", APPS)
def test_wine_app_is_bit_equal_to_the_eager_sharded_runtime(run, arch, mode):
    for r, res in enumerate(run["ranks"]):
        app = res["apps"][arch, mode]
        assert app["bit_equal"], r
        assert app["collectives"] == app["eager_collectives"], r
        assert sum(n for n, _ in app["collectives"].values()), r


@pytest.mark.parametrize("arch,mode", APPS)
def test_wine_app_on_a_mesh_matches_the_reference(run, arch, mode):
    want = run["reference"][f"{arch}/{mode}"]
    assert want["source"] == "compiled"
    got = run["ranks"][0]["apps"][arch, mode]["out"]
    if mode == "train":
        assert abs(got["loss"] - want["loss"]) <= TRAIN_LOSS_ATOL
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=GRAD_NORM_RTOL)
        return
    jl = np.asarray(want["logits"], np.float32)
    assert got["logits"].shape == jl.shape
    np.testing.assert_allclose(got["logits"], jl, atol=LOGIT_ATOL, rtol=0,
                               err_msg=f"{arch} {mode}")


def test_wine_apps_load_again_from_disk(run):
    for res in run["ranks"]:
        assert set(res["disk"].values()) == {"disk"}
        rec = res["record"]
        assert rec["signature_equal"] and rec["cut_leaves"] > 0
        assert rec["sharded_leaves"] > rec["cut_leaves"]
        assert rec["mesh"] == [((2, 2), ("data", "model"))]


def test_settle_waits_a_pending_collective(run):
    for res in run["ranks"]:
        assert res["settle"] == ("AsyncCollectiveTensor", "Tensor", True)


def test_wine_ranks_ran_single_threaded(run):
    assert all(res["threads"] == 1 for res in run["ranks"])
