"""Package-level contracts of the port (``src/repro_torch``).

* Its config copies equal the reference's, field for field, for all ten
  architectures, full and smoke (``paged_kernel`` exempt: the port names its
  own kernels), its parameter count (total, and active: the routed
  experts at top_k / n_experts) equals the reference's for all ten,
  and the full configs fall in the published ranges of
  ``tests/test_models.py``. ``lm_init`` builds all ten at smoke width with
  JAX blocked.
* It imports with JAX blocked, and no file of it — nor ``chip_smoke.py`` —
  imports ``jax`` or the reference package ``repro``; the distributed
  fabric launches, and the dry run, a mesh's split wave and the pipeline
  run, with JAX blocked.
* Its entry points run on the card unless asked for the CPU, and raise
  without one; ``launch.serve.serve`` drives the paged engine end to end.
* bf16 crosses ``convert`` bit for bit.
* ``torch.testing._internal`` (the fake process group of the dry run) is
  imported by ``sharding/spmd.py`` alone.
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models.lm import count_params as j_count_params
from repro_torch.convert import tensor_from_numpy
from repro_torch.models.lm import count_params as t_count_params

# one intra-op thread: the suite runs many test processes side by side
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
# tests/test_models.py::test_param_counts_full_configs, the three families
# this slice brings to the port
PUBLISHED = {"deepseek-v2-236b": (220e9, 250e9),
             "internvl2-76b": (69e9, 72e9),
             "whisper-base": (5e7, 1.2e8)}


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("paged_kernel")
    return d


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_config_copies_match_reference(arch, smoke):
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert (_fields(tconfigs.get_config(arch, smoke))
            == _fields(jconfigs.get_config(arch, smoke)))


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_param_count_matches_reference(arch, smoke):
    jcfg, tcfg = (m.get_config(arch, smoke) for m in (jconfigs, tconfigs))
    assert t_count_params(tcfg) == j_count_params(jcfg)
    assert t_count_params(tcfg, active_only=True) == j_count_params(
        jcfg, active_only=True)
    assert tcfg.param_count() == t_count_params(tcfg)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_active_param_count_matches_reference(arch, smoke):
    jcfg, tcfg = (m.get_config(arch, smoke) for m in (jconfigs, tconfigs))
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert tcfg.active_param_count() == t_count_params(tcfg,
                                                       active_only=True)


@pytest.mark.parametrize("arch", sorted(PUBLISHED))
def test_param_count_in_published_range(arch):
    lo, hi = PUBLISHED[arch]
    assert lo <= t_count_params(tconfigs.get_config(arch)) <= hi


def test_every_architecture_builds_with_jax_blocked():
    """``lm_init`` of all ten smoke configs on the CPU, in a process where
    ``import jax`` fails."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "import torch\n"
            "from repro_torch.configs import ARCHS, get_config\n"
            "from repro_torch.models.lm import lm_init\n"
            "for a in ARCHS:\n"
            "    p = lm_init(torch.Generator().manual_seed(0),\n"
            "                get_config(a, smoke=True), 'cpu')\n"
            "    assert p['embed']['embedding'].device.type == 'cpu', a\n"
            "print(len(ARCHS))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["10"]


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        yield ".".join(parts)


def test_port_imports_with_jax_blocked():
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            f"for m in {list(_modules())!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'repro' or k.startswith('repro.')\n"
            "               for k in sys.modules), 'imported repro'\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_fabric_and_health_plane_run_with_jax_blocked():
    """The scan above covers the distributed fabric, the health plane and
    the examples; one launch of the example over a socket fabric of two
    nodes, with ``obs.report`` rendering its trace, runs on the CPU in a
    process where ``import jax`` fails."""
    mods = set(_modules())
    assert {"repro_torch.dist", "repro_torch.dist.backend",
            "repro_torch.dist.node", "repro_torch.dist.transport",
            "repro_torch.dist.pump", "repro_torch.dist.chunks",
            "repro_torch.dist.registry", "repro_torch.obs.health",
            "repro_torch.obs.statusd", "repro_torch.obs.report",
            "repro_torch.examples",
            "repro_torch.examples.massive_launch"} <= mods
    code = ("import sys, tempfile, os\n"
            "sys.modules['jax'] = None\n"
            "from repro_torch.examples import massive_launch\n"
            "from repro_torch.obs import report\n"
            "path = os.path.join(tempfile.mkdtemp(), 't.json')\n"
            "massive_launch.main(['--device', 'cpu', '--n', '256',\n"
            "                     '--wave', '64', '--nodes', '2',\n"
            "                     '--transport', 'socket', '--obs',\n"
            "                     '--trace-out', path])\n"
            "report.main([path])\n"
            "assert not any(k == 'repro' or k.startswith('repro.')\n"
            "               for k in sys.modules), 'imported repro'\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "per-node split across the fabric over socket" in res.stdout
    assert "llmr.map_reduce" in res.stdout


def test_multidevice_and_analysis_layer_runs_with_jax_blocked():
    """The scan above covers the mesh, sharding, elastic, pipeline,
    roofline, op-counter and dry-run modules; the dry run of one smoke cell,
    a wave split over a mesh listing the CPU twice and a two-stage pipeline
    run in a process where ``import jax`` fails."""
    mods = set(_modules())
    assert {"repro_torch.launch.mesh", "repro_torch.sharding.partition",
            "repro_torch.runtime.elastic", "repro_torch.runtime.pipeline",
            "repro_torch.launch.roofline", "repro_torch.launch.op_analysis",
            "repro_torch.launch.dryrun"} <= mods
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "import numpy as np, torch\n"
            "from repro_torch.launch import dryrun\n"
            "from repro_torch.launch.mesh import Mesh\n"
            "from repro_torch.core.llmr import LLMapReduce\n"
            "from repro_torch.runtime.pipeline import pipeline_apply\n"
            "assert dryrun.main(['--arch', 'qwen3-14b', '--shape',\n"
            "                    'decode_32k', '--smoke']) == 0\n"
            "m = Mesh(['cpu', 'cpu'], ('data',))\n"
            "out, rep = LLMapReduce(mesh=m, wave_size=4).map_reduce(\n"
            "    lambda v: v.sum(), np.ones((8, 3), np.float32))\n"
            "assert out.tolist() == [3.0] * 8\n"
            "assert rep.records[0].extra['mesh_devices'] == ['cpu', 'cpu']\n"
            "y = pipeline_apply(lambda p, x: x * p['w'],\n"
            "                   {'w': torch.tensor([2.0, 3.0])},\n"
            "                   torch.ones(4, 1), Mesh(['cpu'] * 2, ('pod',)))\n"
            "assert y.tolist() == [[6.0]] * 4\n"
            "assert not any(k == 'repro' or k.startswith('repro.')\n"
            "               for k in sys.modules), 'imported repro'\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert '"status": "ok"' in res.stdout


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for mod in _imported(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_fake_process_group_is_imported_only_by_the_spmd_runtime():
    """``torch.testing._internal`` (the dry run's fake process group) is
    internal to torch: one module of the port imports it."""
    users = [p for p in sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             if any(m.startswith("torch.testing._internal")
                    for m in _imported(p))]
    assert users == [PORT / "sharding" / "spmd.py"]


def test_entry_points_need_the_card_unless_asked_for_cpu(monkeypatch):
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.launch.serve import init_params
    from repro_torch.serve.engine import PagedServeEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_config("qwen3-14b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, None)
    params = init_params(cfg, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedServeEngine(cfg, params, slots=2)
    assert PagedServeEngine(cfg, params, slots=2,
                            device="cpu").device.type == "cpu"


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b"])
def test_ssm_entry_points_need_the_card_unless_asked_for_cpu(monkeypatch,
                                                             arch):
    """The SSM family's entry points follow the same rule, and its engine
    runs on the CPU when asked (smoke width)."""
    from repro_torch.launch.serve import init_params, serve
    from repro_torch.serve.engine import PagedServeEngine, Request
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_config(arch, smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, None)
    params = init_params(cfg, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedServeEngine(cfg, params, slots=2)
    reqs = [Request(rid=i, prompt=np.arange(1, 9 + i), max_new=3)
            for i in range(3)]
    eng = serve(cfg, params, [reqs], device="cpu", slots=2, capacity=32)
    assert eng.device.type == "cpu" and not eng._prefix_ok
    assert all(r.done and len(r.out) == 3 for r in reqs)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "gemma2-27b",
                                  "deepseek-v2-236b", "internvl2-76b"])
def test_moe_and_windowed_entry_points_need_the_card_unless_asked_for_cpu(
        monkeypatch, arch):
    """MoE (olmoe), windowed (gemma2), MLA (deepseek-v2) and patch-frontend
    (internvl2, served on tokens alone) configs follow the same rule, and
    their engine serves on the CPU when asked (smoke width; gemma2's
    prompts pass its smoke window of 64)."""
    from repro_torch.launch.serve import init_params, serve
    from repro_torch.serve.engine import PagedServeEngine, Request
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_config(arch, smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, None)
    params = init_params(cfg, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedServeEngine(cfg, params, slots=2)
    reqs = [Request(rid=i, prompt=np.arange(1, 60 + 9 * i), max_new=3)
            for i in range(3)]
    eng = serve(cfg, params, [reqs], device="cpu", slots=2, capacity=96)
    assert eng.device.type == "cpu" and eng.kernel == "gather"
    assert all(r.done and len(r.out) == 3 for r in reqs)
    eng.pool.check()


def test_launch_entry_points_need_the_card_unless_asked_for_cpu(monkeypatch):
    """The launch path's entry points — ``LLMapReduce``, ``make_backend``,
    ``WineAdapter``, ``CompileCache.compile`` — follow the same rule."""
    from repro_torch.core.backend import make_backend
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.core.llmr import LLMapReduce
    from repro_torch.core.wine import WineAdapter
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.ones((4, 2), np.float32)
    for make in (lambda d: LLMapReduce(device=d),
                 lambda d: LLMapReduce(scheduler="serial", device=d),
                 lambda d: make_backend("pipelined", device=d),
                 lambda d: WineAdapter(device=d),
                 lambda d: CompileCache(persistent=False).compile(
                     lambda v: v, (x,), device=d)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(None)
        make("cpu")
    out, _ = LLMapReduce(device="cpu").map_reduce(lambda v: v.sum(), x)
    assert out.device.type == "cpu"


def test_launch_path_imports_with_jax_blocked():
    """One launch through ``LLMapReduce`` and one Wine step, on the CPU,
    in a process where ``import jax`` fails."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "import numpy as np, torch\n"
            "from repro_torch.core.llmr import LLMapReduce\n"
            "from repro_torch.core.wine import WineAdapter, WineApp\n"
            "out, rep = LLMapReduce(wave_size=4, device='cpu').map_reduce(\n"
            "    lambda v: (v * v).sum(), np.ones((10, 3), np.float32))\n"
            "assert out.tolist() == [3.0] * 10 and rep.waves == 3\n"
            "ad = WineAdapter(device='cpu')\n"
            "app = WineApp(arch='qwen3-14b', mode='decode',\n"
            "              shape='decode_32k', smoke=True)\n"
            "inst = ad.load(app)\n"
            "b = {k: torch.ones(v.shape, dtype=v.dtype)\n"
            "     for k, v in ad.input_specs(app).items()}\n"
            "print(tuple(inst.run(b).shape))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["(4,", "1,", "512)"]


def test_engine_refuses_encoder_decoder_configs():
    """The paged engine takes no encoder output, so whisper raises at
    construction, not at its first cross-attention."""
    from repro_torch.launch.serve import init_params
    from repro_torch.serve.engine import PagedServeEngine
    cfg = tconfigs.get_config("whisper-base", smoke=True)
    with pytest.raises(ValueError, match="decoder-only"):
        PagedServeEngine(cfg, init_params(cfg, "cpu"), slots=2,
                         device="cpu")


def test_serve_entry_point_waves_share_prefixes(capsys):
    """``launch.serve.serve`` as ``chip_smoke.py`` calls it, at smoke width
    on the CPU: a first wave registers a system prompt, the second wave's
    sharers admit warm."""
    from repro_torch.launch.serve import init_params, serve
    from repro_torch.serve.engine import Request
    cfg = tconfigs.get_config("qwen3-14b", smoke=True)
    params = init_params(cfg, "cpu")
    r = np.random.default_rng(0)
    system = r.integers(1, cfg.vocab, 16)
    wave = [Request(rid=1 + i, prompt=np.concatenate(
        [system, r.integers(1, cfg.vocab, 16)]) if i < 2
        else r.integers(1, cfg.vocab, 32), max_new=4) for i in range(4)]
    eng = serve(cfg, params, [[Request(rid=0, prompt=system, max_new=4)],
                              wave], device="cpu", slots=2, capacity=64,
                kernel="paged", prefix_sharing=True)
    assert all(q.done and len(q.out) == 4 for q in wave)
    assert eng.stats["prefix_hits"] == 2
    eng.pool.check()
    assert "prefix_hits=2" in capsys.readouterr().out


def test_convert_keeps_bf16_bits():
    x = jax.random.normal(jax.random.PRNGKey(0), (7, 5), jax.numpy.bfloat16)
    t = tensor_from_numpy(np.asarray(x))
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy(),
                          np.asarray(x).view(np.int16))
