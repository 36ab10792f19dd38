"""Meshes through the port's launch path, on the CPU: ``launch.mesh``,
``ArrayBackend`` / ``PipelinedBackend`` / ``make_backend(kind, mesh=,
task_axis=)``, ``LLMapReduce(mesh=)``, the fabric's per-node ``devices=``
and ``WineAdapter(mesh=)``.

A mesh may list the CPU several times (the port's stand-in for the
reference's fake host devices): a wave whose outer axis divides by the
task axis's size is split into that many pieces, each compiled for its own
position (its own executable) and joined in order; the outputs equal the
mesh-less run's bit for bit, and the reference's on its one-device mesh.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.backend import ArrayBackend as JArrayBackend
from repro.core.llmr import LLMapReduce as JLLMapReduce
from repro_torch.configs import get_config
from repro_torch.core.backend import (ArrayBackend, PipelinedBackend,
                                      make_backend)
from repro_torch.core.compile_cache import CompileCache
from repro_torch.core.llmr import LLMapReduce
from repro_torch.core.wine import WineAdapter, WineApp
from repro_torch.dist import NodeAgent, NodeRegistry, spawn_local_nodes
from repro_torch.launch.mesh import (Mesh, make_host_mesh,
                                     make_production_mesh, mesh_device)
from repro_torch.models.blocks import tree_map

torch.set_num_threads(1)

CPU = torch.device("cpu")


def app(x):
    return (x * x).sum() + x[0]


def twice(axis="data"):
    return Mesh([[CPU], [CPU]], (axis, "model"))


X = np.random.default_rng(0).standard_normal((96, 8)).astype(np.float32)


# --- meshes ------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_matches_the_reference_shape(multi_pod):
    m = make_production_mesh(multi_pod=multi_pod)
    want = {"pod": 2, "data": 16, "model": 16} if multi_pod else \
        {"data": 16, "model": 16}
    assert m.is_abstract and m.shape == want and m.size == 512 // (
        1 if multi_pod else 2)
    assert m.distinct_devices == () and mesh_device(m) is None
    assert make_production_mesh(multi_pod=True, pods=8).shape["pod"] == 8


def test_host_mesh_and_a_mesh_listing_one_device_twice():
    h = make_host_mesh("cpu")
    assert h.shape == {"data": 1, "model": 1} and h.distinct_devices == (CPU,)
    m = twice()
    assert m.size == 2 and m.devices_along("data") == [CPU, CPU]
    assert m.distinct_devices == (CPU,) and mesh_device(m) == CPU
    with pytest.raises(ValueError, match="axis names"):
        Mesh([[CPU]], ("data",))
    with pytest.raises(ValueError, match="abstract"):
        make_production_mesh().devices_along("data")


def test_host_mesh_needs_the_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ArrayBackend(mesh=Mesh([[torch.device("cuda", 0)]],
                               ("data", "model")))


# --- backends ------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["array", "pipelined"])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_waves_split_over_the_task_axis(kind, k):
    """Waves of 32 on a mesh of k positions: split where k divides the
    outer axis (each piece its own executable, the record names the
    devices), whole where it does not; outputs equal the mesh-less run."""
    want, _ = LLMapReduce(device="cpu", wave_size=32).map_reduce(app, X)
    mesh = Mesh([CPU] * k, ("data",))
    cache = CompileCache(persistent=False)
    be = make_backend(kind, mesh=mesh, cache=cache)
    assert be.device == CPU and be.mesh is mesh and be.task_axis == "data"
    out, rep = LLMapReduce(backend=be, wave_size=32).map_reduce(app, X)
    assert torch.equal(out, want)
    split = 32 % k == 0
    for r in rep.records:
        assert r.extra.get("mesh_devices") == (["cpu"] * k if split
                                               else None)
    slots = 2 if kind == "pipelined" else 1
    assert cache.stats["misses"] == (k if split else 1) * slots
    out2, rep2 = LLMapReduce(backend=be, wave_size=32).map_reduce(app, X)
    assert torch.equal(out2, want)
    assert {r.extra["compile_source"] for r in rep2.records} == {"memory"}


def test_split_keeps_the_node_core_fan_out():
    mesh = twice()
    be = ArrayBackend(mesh=mesh, inner_lanes=4,
                      cache=CompileCache(persistent=False))
    out, rep = LLMapReduce(backend=be, wave_size=48).map_reduce(app, X)
    want, _ = LLMapReduce(device="cpu", wave_size=48).map_reduce(app, X)
    assert torch.equal(out, want)
    assert rep.records[0].fanout == {"sched": 1, "node": 12, "core": 4}
    assert rep.records[0].extra["mesh_devices"] == ["cpu", "cpu"]


def test_task_axis_names_the_split_axis():
    mesh = Mesh([[CPU, CPU, CPU]], ("data", "model"))
    be = ArrayBackend(mesh=mesh, task_axis="model",
                      cache=CompileCache(persistent=False))
    out, rep = be.launch(app, X[:48], 48)
    assert rep.extra["mesh_devices"] == ["cpu"] * 3
    _, rep = ArrayBackend(mesh=mesh, cache=CompileCache(
        persistent=False)).launch(app, X[:48], 48)
    assert "mesh_devices" not in rep.extra       # data has one position
    want, _ = LLMapReduce(device="cpu").map_reduce(app, X[:48])
    assert torch.equal(out, want)


def test_split_outputs_equal_the_references():
    """The reference's array backend on its one-device mesh against the
    port's on the CPU listed twice: the same values."""
    jmesh = jax.make_mesh((1,), ("data",))
    jout, _ = JLLMapReduce(mesh=jmesh, wave_size=32).map_reduce(
        lambda x: (x * x).sum() + x[0], X)
    out, _ = LLMapReduce(mesh=Mesh([CPU, CPU], ("data",)),
                         wave_size=32).map_reduce(app, X)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6)
    assert JArrayBackend(mesh=jmesh).task_axis == "data"


def test_serial_and_abstract_meshes():
    # the per-instance VM baseline takes no mesh: the factory drops it, as
    # the reference's does, and the device is passed alone
    be = make_backend("serial", mesh=twice(), device="cpu")
    assert be.device == CPU and not hasattr(be, "mesh")
    out, _ = be.launch(app, X[:4], 4)
    assert len(out) == 4
    with pytest.raises(ValueError, match="abstract"):
        ArrayBackend(mesh=make_production_mesh())
    p = PipelinedBackend(mesh=twice(), cache=CompileCache(persistent=False))
    assert p.max_in_flight == 2 and p.device == CPU


def test_llmapreduce_sizes_auto_waves_for_the_meshs_positions():
    seen = []

    def factory(n_tasks, devices, **kw):
        from repro_torch.core.autoscale import WaveController
        seen.append(devices)
        return WaveController(n_tasks=n_tasks, devices=devices, **kw)

    out, _ = LLMapReduce(mesh=Mesh([CPU] * 4, ("data",)), wave_size="auto",
                         controller=factory).map_reduce(app, X)
    want, _ = LLMapReduce(device="cpu").map_reduce(app, X)
    assert torch.equal(out, want) and seen == [4]


# --- the fabric's device subsets -----------------------------------------------

def test_node_devices_make_a_data_mesh():
    reg = NodeRegistry(heartbeat_timeout_s=10.0)
    two = NodeAgent("n0", reg, devices=[CPU, CPU], start=False)
    assert two.devices == [CPU, CPU]
    assert two.backend.mesh.shape == {"data": 2}
    assert two.backend.device == CPU
    out, rec = two.backend.launch(app, X[:32], 32)
    assert rec.extra["mesh_devices"] == ["cpu", "cpu"]
    want, _ = LLMapReduce(device="cpu").map_reduce(app, X[:32])
    assert torch.equal(out, want)
    one = NodeAgent("n1", reg, devices=[CPU], start=False)
    assert one.backend.mesh is None and one.backend.device == CPU


def test_spawned_nodes_partition_the_fabrics_devices():
    """One device (the CPU, or one card) cannot be partitioned among two
    nodes: each runs on the fabric's device; a lone node owns it."""
    reg = NodeRegistry(heartbeat_timeout_s=10.0)
    pair = spawn_local_nodes(2, reg, device="cpu", start=False)
    assert [a.devices for a in pair] == [None, None]
    assert all(a.backend.device == CPU and a.backend.mesh is None
               for a in pair)
    (solo,) = spawn_local_nodes(1, reg, device="cpu", start=False,
                                name_prefix="solo")
    assert solo.devices == [CPU] and solo.backend.device == CPU


# --- Wine ----------------------------------------------------------------------

def _batch(ad, app, seed=0):
    r = np.random.default_rng(seed)
    vocab = get_config(app.arch, smoke=True).vocab
    return {k: torch.from_numpy(r.integers(1, vocab, v.shape).astype(
        np.int32)) if v.dtype == torch.int32 else torch.from_numpy(
        r.standard_normal(v.shape).astype(np.float32)).to(v.dtype)
        for k, v in ad.input_specs(app).items()}


@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-1.3b"])
def test_wine_adapter_runs_apps_on_a_mesh(arch):
    """Train, prefill and decode apps on the host mesh equal the mesh-less
    adapter's; the train state is placed on the mesh; the mesh is part of
    the cache key."""
    cache = CompileCache(persistent=False)
    plain = WineAdapter(backend=ArrayBackend(cache=cache, device="cpu"))
    meshed = WineAdapter(mesh=make_host_mesh("cpu"), cache=cache)
    assert meshed.backend.mesh is meshed.mesh and meshed.device == CPU
    for mode, shape in (("train", "train_4k"), ("prefill", "prefill_32k"),
                        ("decode", "decode_32k")):
        wapp = WineApp(arch=arch, mode=mode, shape=shape, smoke=True)
        batch = _batch(plain, wapp)
        outs = []
        for ad in (plain, meshed):
            inst = ad.load(wapp)
            assert inst.load_report["compile_source"] == "compiled"
            outs.append(inst.run(batch))
            if mode == "train":
                assert inst.state["params"]["embed"]["embedding"].device \
                    == CPU
        a, b = outs
        flat_a, flat_b = [], []
        tree_map(flat_a.append, a if not isinstance(a, tuple) else a[0])
        tree_map(flat_b.append, b if not isinstance(b, tuple) else b[0])
        assert all(torch.equal(x, y) for x, y in zip(flat_a, flat_b)), mode
