"""The port's dry run (``repro_torch.launch.dryrun``), op counter
(``launch.op_analysis``) and Hopper roofline (``launch.roofline``) on the
CPU, against the reference's ``launch.dryrun`` / ``hlo_analysis``.

* ``static_bytes_per_device``, ``model_flops``, ``params`` and
  ``params_active`` equal the reference's ``_tree_device_bytes`` /
  ``model_flops`` / ``count_params`` exactly, for every architecture x
  shape on both production meshes (the reference's trees through
  ``jax.eval_shape`` and its rules on an ``AbstractMesh``; the port's on
  ``meta``). ``MICROBATCHES`` / ``ACCUM_DTYPE`` are pinned copies.
* The op counter's flops on the smoke prefill cell of qwen3 and mamba2
  (smoke widths, the prefill_32k cell's batch and length, as the
  reference's ``--smoke`` dry run) are within 5% of the reference's
  ``hlo_analysis.analyze`` of the same function compiled on the CPU (they
  agree exactly: both count the products alone).
* The ``Roofline`` arithmetic at the H100 constants; no TPU constant
  appears in the port.
* Rows of the production meshes (``run_cell`` and the CLI) carry the
  collectives the step issues under the SPMD runtime (``collectives`` by
  kind, ``collective_bytes_per_chip`` above 0), ``t_collective`` is those
  bytes over 450 GB/s, and no process group is left after a run; a cell
  the runtime cannot run is a ``fail`` row with its error. The counts
  themselves are held against the reference's in
  ``tests/test_torch_spmd.py``.
"""
import importlib
import json
import os
import re
from pathlib import Path

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS, SHAPES, cell_applicable
from repro.configs import get_config as jget
from repro.configs import input_specs as jspecs
from repro.launch.hlo_analysis import analyze
from repro.launch.roofline import Roofline as JRoofline
from repro.models import lm as jlm
from repro.sharding.partition import (cache_sharding as j_cache_sharding,
                                      param_sharding as j_param_sharding)
from repro.train.step import init_state as j_init_state
from repro_torch.configs import get_config as tget
from repro_torch.configs import input_specs as tspecs
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.op_analysis import OpCounter, count
from repro_torch.models import lm as tlm

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jdry():
    """The reference's dry-run module. Importing it sets XLA_FLAGS for 512
    host devices (for a process that has not started jax yet); the
    variable is put back so that no later subprocess inherits it."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def j_mesh(multi_pod):
    return (AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi_pod
            else AbstractMesh((16, 16), ("data", "model")))


def j_static(jdry, arch, cell, mesh):
    """The reference's static bytes a device (``build_cell``'s sums)."""
    cfg = jget(arch)
    key = jax.random.PRNGKey(0)
    if cell.mode == "train":
        s = jax.eval_shape(lambda: j_init_state(key, cfg))
        return jdry._tree_device_bytes(s, j_param_sharding(s, mesh))
    p = jax.eval_shape(lambda: jlm.lm_init(key, cfg))
    if cell.mode == "prefill":
        return jdry._tree_device_bytes(
            p, j_param_sharding(p, mesh, mode="prefill"))
    c = jax.eval_shape(lambda: jlm.cache_init(cfg, cell.global_batch,
                                              cell.seq_len))
    return (jdry._tree_device_bytes(p, j_param_sharding(p, mesh,
                                                        mode="serve"))
            + jdry._tree_device_bytes(c, j_cache_sharding(c, mesh, "serve")))


def test_tables_are_pinned_copies(jdry):
    assert dryrun.MICROBATCHES == jdry.MICROBATCHES
    assert set(dryrun.ACCUM_DTYPE) == set(jdry.ACCUM_DTYPE)
    for k, v in jdry.ACCUM_DTYPE.items():
        assert str(dryrun.ACCUM_DTYPE[k]).split(".")[-1] == v.dtype.name


@pytest.mark.parametrize("arch", ARCHS)
def test_static_bytes_and_model_flops_equal_the_references(jdry, arch):
    cfg = tget(arch)
    assert tlm.count_params(cfg) == jlm.count_params(jget(arch))
    assert (tlm.count_params(cfg, active_only=True)
            == jlm.count_params(jget(arch), active_only=True))
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        for cell in SHAPES:
            if not cell_applicable(arch, cell)[0]:
                continue
            _, _, static = dryrun.build_cell(arch, cell, mesh)
            assert static == j_static(jdry, arch, cell, j_mesh(multi_pod)), (
                cell.name, multi_pod)
            assert (dryrun.model_flops(cfg, cell)
                    == jdry.model_flops(jget(arch), cell))


@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-1.3b"])
def test_op_counter_flops_match_hlo_analysis(arch):
    cell = [c for c in SHAPES if c.name == "prefill_32k"][0]
    jc, tc = jget(arch, smoke=True), tget(arch, smoke=True)
    shapes = jax.eval_shape(lambda: jlm.lm_init(jax.random.PRNGKey(0), jc))
    specs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
             for k, v in jspecs(jc, cell).items()}
    compiled = jax.jit(lambda p, i: jlm.prefill(p, i, jc)).lower(
        shapes, specs).compile()
    want = analyze(compiled.as_text()).flops
    params = tlm.lm_init(None, tc, "meta")
    inputs = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
              for k, v in tspecs(tc, cell).items()}
    (logits, _), cost = count(tlm.prefill, params, inputs, tc)
    assert logits.shape == (cell.global_batch, 1, tc.vocab)
    assert want > 0 and abs(cost.flops / want - 1) <= 0.05, (cost.flops,
                                                             want)
    assert cost.hbm_bytes > 0 and cost.ops > 0
    assert cost.top(3, by="flops")[0][0] in ("mm", "bmm")


def test_op_counter_counts_products_views_and_in_place_ops():
    a = torch.ones(8, 16)
    b = torch.ones(16, 4)
    with OpCounter() as c:
        y = a @ b                       # mm: 2*8*16*4 flops
        v = y.view(32)                  # a view: no bytes
        v.add_(1.0)                     # in place: reads and writes y
    assert c.cost.flops == 2 * 8 * 16 * 4
    rows = {n: (f, b_, k) for n, f, b_, k in c.cost.top(10)}
    assert rows["mm"][1] == (8 * 16 + 16 * 4 + 8 * 4) * 4
    assert rows["view"][1] == 0
    assert rows["add_"][1] == 2 * 32 * 4
    assert torch.equal(y, torch.full((8, 4), 17.0))


def test_roofline_arithmetic_at_the_h100_constants():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    r = roofline.Roofline(flops=989e12, hbm_bytes=6.7e12,
                          collective_bytes=450e9, model_flops=2 * 989e12,
                          chips=4)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(2.0)
    assert r.t_collective == pytest.approx(1.0)
    assert r.bound == "memory" and r.t_step == pytest.approx(2.0)
    assert r.useful_flops_frac == pytest.approx(0.5)
    assert r.mfu_bound == pytest.approx(0.25)
    assert set(r.row()) == set(JRoofline(1.0, 1.0, 1.0).row())
    n = roofline.Roofline(flops=0.0, hbm_bytes=0.0, collective_bytes=None)
    assert n.t_collective == 0.0 and n.useful_flops_frac == 0.0
    assert n.mfu_bound == 0.0
    assert roofline.Roofline(1e9, 1.0, None).bound == "compute"


def test_no_tpu_constant_in_the_port():
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        text = path.read_text()
        for const in ("197e12", "819e9", "50e9"):
            assert not re.search(rf"(?<![0-9.]){const}", text), (path, const)


def test_run_cell_and_the_cli(tmp_path, capsys):
    rec = dryrun.run_cell("qwen3-14b", "decode_32k", False, smoke=True)
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    assert rec["bound"] == "memory" and rec["collective_bytes_per_chip"] > 0
    assert rec["collectives"] and rec["collective_bytes_per_chip"] == sum(
        b for _, b in rec["collectives"].values())
    assert rec["flops_per_chip"] > 0 and rec["op_bytes_per_chip"] > 0
    # the untied input embedding's rows no token gathers are not counted:
    # a 1/256 share a device (the table cut over both axes), all rows but B
    cfg = tget("qwen3-14b", smoke=True)
    B = tspecs(cfg, SHAPES[2])["tokens"].shape[0]
    held = cfg.vocab * cfg.d_model * 2 // 256
    assert not cfg.tie_embeddings and B < cfg.vocab
    assert rec["hbm_bytes_per_chip"] == rec["static_bytes_per_device"] - (
        held * (cfg.vocab - B) // cfg.vocab)
    assert dryrun.run_cell("qwen3-14b", "long_500k", True)["status"] == \
        "skipped"
    out = tmp_path / "rows.jsonl"
    assert dryrun.main(["--arch", "mamba2-1.3b", "--shape", "train_4k",
                        "--both-meshes", "--smoke", "--out", str(out)]) == 0
    lines = out.read_text().splitlines()
    assert len(lines) == 2 and all('"status": "ok"' in l for l in lines)
    assert '"mesh": "2x16x16"' in capsys.readouterr().out
    for row in map(json.loads, lines):
        assert row["collective_bytes_per_chip"] > 0 and row["collectives"]
    assert not torch.distributed.is_initialized()


def test_the_collective_term_is_its_bytes_over_the_link_rate():
    """A production-mesh row's t_collective is its collective bytes a chip
    over 450 GB/s; its bytes are the sum of its table; the run leaves no
    process group behind; a one-chip row sends nothing."""
    rec = dryrun.run_cell("mamba2-1.3b", "decode_32k", False, smoke=True)
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["t_collective"] == rec["collective_bytes_per_chip"] / 450e9
    assert rec["collective_bytes_per_chip"] == sum(
        b for _, b in rec["collectives"].values()) > 0
    assert set(rec["collectives"]) <= {"all-reduce", "all-gather",
                                       "reduce-scatter", "all-to-all",
                                       "collective-broadcast"}
    assert not torch.distributed.is_initialized()
    cost, coll, _, _ = dryrun.count_cell(
        "mamba2-1.3b", SHAPES[2], Mesh.abstract((1,), ("data",)), smoke=True)
    row = dryrun.roofline_row(cost, 1.0, 1.0, 1, coll)
    assert row["collective_bytes_per_chip"] == 0.0 and row["collectives"] == {}


def test_a_cell_the_runtime_cannot_run_is_a_fail_row(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("no strategy")
    monkeypatch.setattr(dryrun, "count_cell", broken)
    rec = dryrun.run_cell("qwen3-14b", "decode_32k", False, smoke=True)
    assert rec["status"] == "fail" and "no strategy" in rec["error"]
    assert "collective_bytes_per_chip" not in rec


@pytest.mark.parametrize("arch,shape", [("qwen3-14b", "decode_32k"),
                                        ("qwen3-14b", "prefill_32k"),
                                        ("qwen3-14b", "train_4k"),
                                        ("gemma2-27b", "decode_32k")])
def test_must_move_drops_only_the_embedding_rows_no_token_gathers(
        arch, shape):
    """At full size on the 16 x 16 mesh: a decode step of an untied
    embedding moves B of its rows (the reference's shard count of the
    table), a prefill of more tokens than rows and a train step move the
    whole table, a tied table is read whole by the logits."""
    cell = next(c for c in SHAPES if c.name == shape)
    mesh = make_production_mesh(multi_pod=False)
    fn, args, static = dryrun.build_cell(arch, cell, mesh)
    cfg = tget(arch)
    must = dryrun.must_move_bytes(cfg, cell, mesh, args, static)
    if cell.mode != "decode" or cfg.tie_embeddings:
        assert must == static
        return
    jcfg = jget(arch)
    jp = jax.eval_shape(lambda: jlm.lm_init(jax.random.PRNGKey(0), jcfg))
    sh = j_param_sharding(jp, j_mesh(False), mode="serve")
    spec = sh["embed"]["embedding"].spec
    shards = 1
    for axes in spec:
        for ax in ((axes,) if isinstance(axes, str) else (axes or ())):
            shards *= dict(zip(j_mesh(False).axis_names,
                               j_mesh(False).axis_sizes))[ax]
    held = cfg.vocab * cfg.d_model * 2 // shards
    B = cell.global_batch
    assert static - must == held * (cfg.vocab - B) // cfg.vocab > 0
