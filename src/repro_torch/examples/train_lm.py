"""End-to-end training example: data pipeline -> train loop ->
checkpoint/restart fault tolerance. Port of the reference's
``examples/train_lm.py``.

Default runs a ~20M-parameter qwen3-family model for 60 steps;
``--steps``/``--seq``/``--batch``/``--d-model``/``--layers`` scale it.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 60]
        [--inject-failure] [--ckpt-dir DIR] [--device cpu]

The train step (forward, backward and AdamW) goes through
``backend.compile`` with the state bound at its addresses: on the card a
CUDA graph captured on the first step and replayed after; a restart
restores the checkpoint into the bound tensors, so the graph keeps
replaying. Checkpoints default to ``repro_torch_train_ckpt`` in the temp
directory (never the reference's directory: the two packages read each
other's checkpoints, so a stale reference run would be restored). Runs on
the card unless ``--device cpu`` is given; without a card and without
``--device cpu`` it fails.
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs.common import dense_lm
from repro_torch.core.backend import ArrayBackend
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.lm import count_params
from repro_torch.runtime.fault import (FaultConfig, WorkerFailure,
                                       resilient_train)
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import init_state, make_train_step

#: the default ``--ckpt-dir``: the port's own, never the reference's
CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--inject-failure", action="store_true",
                    help="kill a 'worker' mid-run to demo restart")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = dense_lm("train-demo", n_layers=args.layers, d_model=args.d_model,
                   n_heads=8, n_kv=4, head_dim=args.d_model // 8,
                   d_ff=args.d_model * 4, vocab=args.vocab, qk_norm=True)
    print(f"model: {count_params(cfg) / 1e6:.1f}M params, "
          f"{cfg.n_layers}L d={cfg.d_model}")

    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch,
                      vocab=cfg.vocab)
    opt = AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = init_state(gen, cfg, dev)

    def batch_fn(s):
        return {k: torch.from_numpy(v).to(dev, torch.int32)
                for k, v in synth_batch(dcfg, s, cfg).items()}

    step, source = ArrayBackend(device=dev).compile(
        make_train_step(cfg, opt), (state, batch_fn(0)), bind_argnums=(0,),
        extras=("train-demo", cfg.name, opt))
    print(f"train step: {source} on {dev}")

    failure_hook = None
    if args.inject_failure:
        armed = {"on": True}

        def failure_hook(s):
            if s == args.steps // 2 and armed["on"]:
                armed["on"] = False
                print(f"!! injected worker failure at step {s}")
                raise WorkerFailure("node lost")

    fcfg = FaultConfig(ckpt_dir=args.ckpt_dir, ckpt_every=20, async_save=True)
    t0 = time.perf_counter()
    losses = []

    def logged_step(state, batch):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if len(losses) % 10 == 0:
            dt = time.perf_counter() - t0
            tps = dcfg.global_batch * dcfg.seq_len * len(losses) / dt
            print(f"step {len(losses):4d}  loss {losses[-1]:.4f}  "
                  f"{tps:,.0f} tok/s")
        return state, m

    state, report = resilient_train(logged_step, state, batch_fn, args.steps,
                                    fcfg, failure_hook=failure_hook)
    print(f"done: {report.steps_run} steps, {report.restarts} restarts, "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({time.perf_counter() - t0:.1f}s)")
    assert losses[-1] < losses[0], "loss did not improve"
    return report


if __name__ == "__main__":
    main()
