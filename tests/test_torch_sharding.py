"""The port's logical-axis sharding (``repro_torch.sharding.partition``)
against the reference's (``repro.sharding.partition``).

* The rule tables are pinned copies of the reference's.
* The reference's ``tests/test_sharding.py`` cases, run against the port.
* ``resolve_spec`` equals the reference's under hypothesis shapes, on the
  reference's ``AbstractMesh`` and the port's abstract ``Mesh`` of the same
  shape: 4 x 2, 16 x 16 and 2 x 16 x 16.
* ``param_sharding`` / ``cache_sharding`` / ``batch_sharding`` spec trees
  equal the reference's leaf for leaf, for all ten architectures (smoke and
  full: the reference's trees through ``jax.eval_shape``, the port's on
  ``meta``), in every mode, on the three meshes.
"""
import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import AbstractMesh
from torch.utils import _pytree as pytree

import repro.sharding.partition as jp
import repro_torch.sharding.partition as tp
from repro.configs import ARCHS, get_config as jget, input_specs as jspecs
from repro.models import lm as jlm
from repro.models.spec import SHAPES
from repro.train.step import init_state as jinit
from repro_torch.configs import get_config as tget, input_specs as tspecs
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm as tlm
from repro_torch.train.step import init_state as tinit

MESHES = {"4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
TABLES = ("PARAM_RULES", "ACT_RULES", "PRIORITY", "PARAM_LOGICAL",
          "CACHE_LOGICAL", "SERVE_PARAM_RULES")
MODES = ("train", "prefill", "serve")


def meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), Mesh.abstract(sizes, names)


def mesh2():
    return Mesh.abstract((4, 2), ("data", "model"))


P = tp.PartitionSpec


@pytest.mark.parametrize("table", TABLES)
def test_rule_tables_are_pinned_copies(table):
    assert getattr(tp, table) == getattr(jp, table)


# --- the reference's tests/test_sharding.py cases, against the port -------

def test_divisible_dims_get_sharded():
    spec = tp.resolve_spec((8, 16), ("d_model", "ff"), mesh2(),
                           tp.PARAM_RULES)
    assert spec == P("data", "model")


def test_indivisible_dim_falls_back_to_replication():
    spec = tp.resolve_spec((8, 15), ("d_model", "ff"), mesh2(),
                           tp.PARAM_RULES)
    assert spec == P("data", None)


def test_heads_fallback_to_seq():
    spec = tp.resolve_spec((8, 64, 9, 16),
                           ("batch", "seq", "heads", "head_dim"), mesh2(),
                           tp.ACT_RULES["train"])
    assert spec[2] is None and spec[1] == "model"


def test_heads_win_over_seq_when_divisible():
    spec = tp.resolve_spec((8, 64, 8, 16),
                           ("batch", "seq", "heads", "head_dim"), mesh2(),
                           tp.ACT_RULES["train"])
    assert spec[2] == "model" and spec[1] is None


def test_cache_batch1_falls_back_to_seq_sharding():
    logical = ("cache_batch", "cache_seq", "kv_heads", "head_dim")
    spec = tp.resolve_spec((1, 1024, 8, 64), logical, mesh2(),
                           tp.ACT_RULES["serve"])
    assert spec[0] is None
    assert spec[1] == "data" and spec[2] == "model"
    spec = tp.resolve_spec((1, 1024, 3, 64), logical, mesh2(),
                           tp.ACT_RULES["serve"])
    assert spec[1] == ("data", "model") and spec[2] is None


@given(d0=st.integers(1, 64), d1=st.integers(1, 64))
@settings(max_examples=40, deadline=None)
def test_resolution_always_divides(d0, d1):
    spec = tp.resolve_spec((d0, d1), ("d_model", "ff"), mesh2(),
                           tp.PARAM_RULES)
    mesh_shape = {"data": 4, "model": 2}
    for dim, part in zip((d0, d1), spec):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        assert dim % int(np.prod([mesh_shape[a] for a in axes])) == 0


def test_no_axis_reused_within_tensor():
    spec = tp.resolve_spec((8, 8, 8), ("experts", "d_model", "ff"), mesh2(),
                           tp.PARAM_RULES)
    used = []
    for part in spec:
        if part is None:
            continue
        used += list(part) if isinstance(part, tuple) else [part]
    assert len(used) == len(set(used))


def test_param_tree_sharding_covers_all_archs():
    for arch in ARCHS:
        params = tlm.lm_init(None, tget(arch, smoke=True), "meta")
        tree = tp.param_sharding(params, mesh2())
        assert (len(pytree.tree_leaves(tree))
                == len(pytree.tree_leaves(params)))


# --- resolve_spec against the reference's, under hypothesis shapes --------

LOGICAL = sorted({k for r in (tp.PARAM_RULES, *tp.ACT_RULES.values())
                  for k in r}) + [None]
RULES = {"param": tp.PARAM_RULES, "serve_param": tp.SERVE_PARAM_RULES,
         **{f"act_{m}": tp.ACT_RULES[m] for m in MODES}}
JRULES = {"param": jp.PARAM_RULES, "serve_param": jp.SERVE_PARAM_RULES,
          **{f"act_{m}": jp.ACT_RULES[m] for m in MODES}}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@given(dims=st.lists(st.sampled_from([1, 2, 3, 4, 5, 8, 9, 12, 16, 32, 40,
                                      48, 64, 128, 256, 512, 1024]),
                     min_size=1, max_size=5),
       names=st.lists(st.sampled_from(LOGICAL), min_size=5, max_size=5),
       rules=st.sampled_from(sorted(RULES)))
@settings(max_examples=60, deadline=None)
def test_resolve_spec_matches_reference(mesh, dims, names, rules):
    jm, tm = meshes(mesh)
    logical = tuple(names[:len(dims)])
    want = jp.resolve_spec(tuple(dims), logical, jm, JRULES[rules])
    got = tp.resolve_spec(tuple(dims), logical, tm, RULES[rules])
    assert isinstance(got, tuple)
    assert tuple(got) == tuple(want)


# --- spec trees, leaf for leaf ----------------------------------------------

def _key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def jspec_tree(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec"))
    return {_key(p): tuple(s.spec) for p, s in leaves}


def tspec_tree(tree) -> dict:
    leaves, _ = pytree.tree_flatten_with_path(tree)
    assert all(isinstance(s, tp.NamedSharding) for _, s in leaves)
    return {_key(p): tuple(s.spec) for p, s in leaves}


def _j_inputs(cfg, cell):
    return {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
            for k, v in jspecs(cfg, cell).items()}


def _t_inputs(cfg, cell):
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in tspecs(cfg, cell).items()}


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_match_reference(arch, smoke):
    """Every param (with the AdamW state), cache and batch leaf gets the
    reference's spec, in every mode, on every mesh; caches at the
    decode_32k and long_500k cells' sizes."""
    jc, tc = jget(arch, smoke), tget(arch, smoke)
    jstate = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jc))
    tstate = tinit(None, tc, "meta")
    caches = [(jax.eval_shape(lambda c=c: jlm.cache_init(
        jc, c.global_batch, c.seq_len)),
        tlm.cache_init(tc, c.global_batch, c.seq_len, "meta"))
        for c in SHAPES if c.mode == "decode"]
    for name in MESHES:
        jm, tm = meshes(name)
        for mode in MODES:
            for j, t in ((jstate, tstate),
                         (jstate["params"], tstate["params"])):
                want = jspec_tree(jp.param_sharding(j, jm, mode))
                assert tspec_tree(tp.param_sharding(t, tm, mode)) == want
            for j, t in caches:
                want = jspec_tree(jp.cache_sharding(j, jm, mode))
                assert tspec_tree(tp.cache_sharding(t, tm, mode)) == want
            for cell in SHAPES:
                want = jspec_tree(jp.batch_sharding(_j_inputs(jc, cell), jm,
                                                    mode))
                got = tspec_tree(tp.batch_sharding(_t_inputs(tc, cell), tm,
                                                   mode))
                assert got == want, (name, mode, cell.name)
