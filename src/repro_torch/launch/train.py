"""Training launcher CLI: any registered architecture, fault-tolerant loop.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \
        --smoke --device cpu --steps 20 [--batch 4 --seq 64] [--microbatches 2]

Port of ``repro.launch.train``. Runs on the card unless ``--device cpu`` is
given, and fails without one. The train step (forward, backward and AdamW,
``train.step``) is compiled through one ``ArrayBackend``: on the card it is
captured as a CUDA graph on its first step, with the state bound at its
addresses and each batch copied into the graph's static buffers, then
replayed; ``--eager`` runs it eagerly. The restart loop
(``runtime.fault.resilient_train``) checkpoints every ``--ckpt-every``
steps into ``--ckpt-dir``. ``train()`` is the entry point the CLI and
``chip_smoke.py`` share.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, Optional

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.backend import ArrayBackend
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.lm import count_params
from repro_torch.models.spec import ModelConfig
from repro_torch.runtime.fault import FaultConfig, resilient_train
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import init_state, make_train_step


def batch_fn(cfg: ModelConfig, dcfg: DataConfig, device) -> Callable:
    """step -> the seeded synthetic batch of that step as tensors on
    ``device`` (tokens and labels int32, embeds / frames bf16)."""
    def fn(step: int) -> dict:
        out = {}
        for k, v in synth_batch(dcfg, step, cfg).items():
            t = torch.from_numpy(v)
            out[k] = t.to(device, torch.bfloat16 if t.is_floating_point()
                          else torch.int32)
        return out
    return fn


def compile_step(cfg: ModelConfig, opt: AdamWConfig, state: dict,
                 example_batch: dict, *, microbatches: int = 1,
                 backend: Optional[ArrayBackend] = None, device=None,
                 capture_step: bool = True) -> tuple:
    """(step, source): the train step through ``backend.compile`` with the
    state bound at its addresses (a CUDA graph on the card), or the eager
    function with source "eager" when ``capture_step`` is False."""
    fn = make_train_step(cfg, opt, microbatches=microbatches)
    if not capture_step:
        return fn, "eager"
    backend = backend or ArrayBackend(device=device)
    return backend.compile(fn, (state, example_batch), bind_argnums=(0,),
                           extras=("train", cfg.name, microbatches, opt))


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          lr: float = 1e-3, microbatches: int = 1, device=None,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 25,
          capture_step: bool = True):
    """Train ``cfg`` from random weights (seed 0) for ``steps`` steps on
    seeded synthetic data. Returns (state, RunReport, compile_sources):
    ``compile_sources["step"]`` is "compiled" or "memory" (through the
    compile cache; a CUDA graph on the card) or "eager"."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = init_state(gen, cfg, dev)
    dcfg = DataConfig(seq_len=seq, global_batch=batch, vocab=cfg.vocab)
    opt = AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                      total_steps=steps)
    get_batch = batch_fn(cfg, dcfg, dev)
    step, source = compile_step(cfg, opt, state, get_batch(0),
                                microbatches=microbatches, device=dev,
                                capture_step=capture_step)
    losses = []

    def logged(state, b):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        if len(losses) % 10 == 0:
            print(f"step {len(losses):4d}  loss {losses[-1]:.4f}  "
                  f"lr {float(m['lr']):.2e}")
        return state, m

    fcfg = FaultConfig(ckpt_dir=ckpt_dir or os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"), ckpt_every=ckpt_every)
    state, report = resilient_train(logged, state, get_batch, steps, fcfg)
    return state, report, {"step": source}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_ckpt in the temp directory")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the CPU")
    ap.add_argument("--eager", action="store_true",
                    help="run the step eagerly (no CUDA graph)")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=args.smoke)
    print(f"{cfg.name}: {count_params(cfg) / 1e6:.1f}M params")
    t0 = time.perf_counter()
    _, report, sources = train(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
        microbatches=args.microbatches, device=args.device,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        capture_step=not args.eager)
    losses = report.losses
    print(f"done {report.steps_run} steps in {time.perf_counter() - t0:.1f}s"
          f"  loss {losses[0]:.3f} -> {losses[-1]:.3f}  compile_sources "
          f"{sources}")


if __name__ == "__main__":
    main()
