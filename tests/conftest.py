import os
import sys
import tempfile

# keep tests single-device (the dry-run sets its own 512-device flag in its
# own process); cap compilation parallelism for container stability
os.environ.setdefault("XLA_FLAGS", "--xla_cpu_multi_thread_eigen=false")

# tests that fall through to the default CompileCache must not spill AOT
# executables into (or warm-start from) the user's real ~/.cache dir
os.environ["REPRO_COMPILE_CACHE_DIR"] = tempfile.mkdtemp(
    prefix="repro-aot-test-")

import jax  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

# the hermetic container has no `hypothesis`; fall back to the bundled
# deterministic stub so the property tests still collect and sweep
try:
    import hypothesis  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    from repro._compat.hypothesis_stub import build_module

    _hyp = build_module()
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _hyp.strategies


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one; run "
        "them on the card with `python -m pytest -m cuda tests/`)")
