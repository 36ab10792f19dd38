"""The port's examples (``python -m repro_torch.examples.<name>``) on the
CPU at tiny sizes, through their ``main(argv)``:

* ``quickstart``: the array and serial launches run, and the paper-scale
  lines equal the reference example's (``core.launch_model`` is a pinned
  copy);
* ``serve_batch``: prefill and a decode step through the Wine adapter's
  backend (source "compiled"), tokens in the vocabulary;
* ``train_lm --inject-failure``: one restart, resumed at the restored step,
  and the loss falls.

Each example also fails without a card unless ``--device cpu`` is given.
``tests/test_torch_package.py``'s import scan covers the three files.
"""
import importlib.util
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.examples import quickstart, serve_batch, train_lm

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _paper_lines(out: str) -> list:
    lines = out.splitlines()
    return lines[lines.index("== paper-scale model (16,384 instances on 256 "
                             "KNL nodes)"):]


def test_quickstart_runs_and_its_paper_lines_equal_the_reference(
        capsys, monkeypatch):
    quickstart.main(["--n", "256", "--serial-n", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "== LLMapReduce array launch, n=256" in out
    assert "waves=1" in out
    assert "== serial per-instance launch (VM-style), n=4" in out
    spec = importlib.util.spec_from_file_location(
        "reference_quickstart", ROOT / "examples" / "quickstart.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    monkeypatch.setattr(sys, "argv", ["quickstart.py", "--n", "64",
                                      "--serial-n", "2"])
    ref.main()
    want = capsys.readouterr().out
    assert _paper_lines(out) == _paper_lines(want)
    assert len(_paper_lines(out)) == 5


def test_quickstart_app_matches_the_reference_app():
    import jax.numpy as jnp
    import numpy as np
    spec = importlib.util.spec_from_file_location(
        "reference_quickstart", ROOT / "examples" / "quickstart.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    x = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    got = float(quickstart.app(torch.from_numpy(x)))
    assert got == pytest.approx(float(ref.app(jnp.asarray(x))), rel=1e-5)


def test_serve_batch_decodes_through_the_backend(capsys):
    toks = serve_batch.main(["--device", "cpu", "--batch", "2",
                             "--prompt-len", "8", "--gen-len", "4"])
    out = capsys.readouterr().out
    assert toks.shape == (2, 4)
    assert bool(((toks >= 0) & (toks < 512)).all())
    assert "prefill 2x8" in out and "decoded 6 tokens" in out
    assert "decode step: compiled" in out
    assert "sample generation (token ids):" in out


def test_train_lm_restarts_and_resumes_at_the_restored_step(capsys,
                                                            tmp_path):
    report = train_lm.main(["--device", "cpu", "--steps", "8",
                            "--inject-failure", "--d-model", "32",
                            "--layers", "2", "--seq", "32", "--batch", "2",
                            "--vocab", "256",
                            "--ckpt-dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert "!! injected worker failure at step 4" in out
    assert report.restarts == 1 and report.restore_steps == [0]
    assert report.steps_run == 4 + 8          # resumed from step 0
    assert report.losses[-1] < report.losses[0]
    assert "done: 12 steps, 1 restarts" in out


def test_train_lm_default_checkpoints_are_not_the_reference_s():
    assert train_lm.CKPT_DIR != "/tmp/repro_train_ckpt"
    assert Path(train_lm.CKPT_DIR).name == "repro_torch_train_ckpt"


@pytest.mark.parametrize("mod", [quickstart, serve_batch, train_lm],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_example_needs_the_card_unless_asked_for_the_cpu(mod, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"quickstart": ["--n", "8", "--serial-n", "1"],
            "serve_batch": ["--gen-len", "2"],
            "train_lm": ["--steps", "1"]}[mod.__name__.rsplit(".", 1)[-1]]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
