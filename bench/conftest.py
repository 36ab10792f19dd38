"""Test helpers of the benchmark's own CPU tests: a scratch checkout that
holds the smoke cells of ``testdata/`` beside the real metric readers."""
import os
import shutil
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
for p in (BENCH_DIR, os.path.join(os.path.dirname(BENCH_DIR), "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture
def smoke_root(tmp_path):
    """A checkout of the smoke cells: BENCHMARK.json at its root, their
    configurations, mixes and limits under bench/, the real readers."""
    b = tmp_path / "bench"
    shutil.copytree(os.path.join(BENCH_DIR, "testdata"), b)
    shutil.copy(b / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(os.path.join(BENCH_DIR, "metrics"), b / "metrics")
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(2)          # one light process, as a run is
    yield tmp_path
    torch.set_num_threads(threads)
