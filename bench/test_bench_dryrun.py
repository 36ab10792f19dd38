"""The harness driven end to end on the CPU at the smoke sizes (its look
for a card skipped): the result line, the metrics, the no-JAX check, a new
cell made of files alone, and a run without a card."""
import ast
import json
import os
import subprocess
import sys
import time

import pytest

import run as R
from benchkit import specs

SEED = 2**31 + 99


def _run(root, cell, trace, **kw):
    bench = specs.Bench(str(root))
    res = R.run_cell(bench, bench.cell(cell), SEED, 2.0, trace, "cpu",
                     time.perf_counter(), **kw)
    return bench, res, R.result_line(res, {"platform": "cpu"}, trace)


@pytest.mark.parametrize("cell", ["ssm-smoke", "mla-smoke"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(smoke_root, cell, trace):
    bench, res, line = _run(smoke_root, cell, trace)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert ("breakdown" in keys) == trace
    json.dumps(line)
    assert isinstance(line["correct"], bool)
    assert line["attempted"] > 0 and line["failed"] == 0
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"] for m in bench.metrics_of(bench.cell(cell), kind)}
    assert set(line["metrics"]) <= allowed
    if not trace:
        assert set(line["metrics"]) == allowed
    for m in line["metrics"].values():
        assert m["value"] is not None and m["value"] > 0
    assert set(line["checks"]) == set(bench.limits(cell))
    if cell == "ssm-smoke":
        assert line["correct"] is True


def test_new_cell_from_files_alone(smoke_root):
    """A cell added with a traffic file, a limits file and one entry of
    BENCHMARK.json, and no code, runs."""
    b = smoke_root / "bench"
    mix = json.load(open(b / "traffic" / "ssm_smoke.json"))
    mix.update(rate_per_s=12.0, prompt_len={"choices": [8, 32]})
    json.dump(mix, open(b / "traffic" / "ssm_other.json", "w"))
    (b / "limits" / "ssm-other.json").write_text(
        (b / "limits" / "ssm-smoke.json").read_text())
    spec = json.load(open(smoke_root / "BENCHMARK.json"))
    spec["workloads"].append({"name": "ssm-other", "config": "mamba2-smoke",
                              "traffic": "ssm_other", "chips": 1,
                              "why": "another mix"})
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            if "ssm-smoke" in m.get("workloads", []):
                m["workloads"].append("ssm-other")
    json.dump(spec, open(smoke_root / "BENCHMARK.json", "w"))
    _, res, line = _run(smoke_root, "ssm-other", False)
    assert line["correct"] is True and "ttft_p90_ms" in line["metrics"]


def test_forbidden_names_compared_whole():
    assert R.forbidden_modules(["repro_torch", "repro_torch.serve",
                                "jaxtyping", "reprox", "torch"]) == []
    assert R.forbidden_modules(["repro.core", "jax.numpy", "jaxlib",
                                "flax.linen", "numpy"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def test_a_run_loads_no_jax(smoke_root):
    """A smoke run in a fresh process leaves no JAX, jaxlib, flax or JAX
    package module loaded."""
    code = (
        "import sys, time; sys.path[:0] = [{bench!r}, {src!r}]\n"
        "import run as R\nR.environment({root!r})\n"
        "from benchkit import specs\nb = specs.Bench({root!r})\n"
        "R.run_cell(b, b.cell('mla-smoke'), 7, 0.5, False, 'cpu', "
        "time.perf_counter())\n"
        "print('LOADED', R.forbidden_modules())\n").format(
            bench=specs.BENCH_DIR, src=os.path.join(specs.ROOT, "src"),
            root=str(smoke_root))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout


def test_harness_sources_import_no_jax():
    """No file of the benchmark imports JAX, jaxlib, flax or the JAX
    package (whole top-level names); the references import nothing of the
    program either."""
    for dirpath, _, files in os.walk(specs.BENCH_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tree = ast.parse(open(path).read())
            tops = set()
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    tops |= {a.name.split(".")[0] for a in node.names}
                elif isinstance(node, ast.ImportFrom) and node.module:
                    tops.add(node.module.split(".")[0])
            assert not tops & set(R.FORBIDDEN), path
            if os.sep + "reference" + os.sep in path:
                assert "repro_torch" not in tops, path


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, os.path.join(specs.BENCH_DIR, "run.py"),
         "--workload", "mamba2-chat", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=specs.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
