"""Quickstart: the paper's experiment at laptop scale. Port of the
reference's ``examples/quickstart.py``.

Launch N instances of an 'application' two ways — serial per-instance
provisioning (the heavyweight-VM baseline: a new executable and CUDA-graph
capture per instance) and one LLMapReduce array job (one graph of the
vmapped app, replayed per wave) — and print the launch-time/rate table,
then the paper-scale model.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--n 1024]
        [--serial-n 32] [--device cpu]

Runs on the card unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it fails.
"""
import argparse
import time

import torch

from repro_torch.core.launch_model import CURVES, headline
from repro_torch.core.llmr import launch_instances


def app(x):
    """The 'Windows application': a small compute task per instance."""
    return torch.tanh(x @ torch.ones((x.shape[-1], 16), dtype=x.dtype,
                                     device=x.device)).sum()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--serial-n", type=int, default=32,
                    help="instances for the (slow) serial baseline")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)

    print(f"== LLMapReduce array launch, n={args.n}")
    t0 = time.perf_counter()
    _, report = launch_instances(app, args.n, scheduler="array",
                                 device=args.device)
    dt = time.perf_counter() - t0
    print(f"   total {dt:.3f}s  rate {args.n / dt:,.0f} inst/s  "
          f"waves={report.waves}")

    print(f"== serial per-instance launch (VM-style), n={args.serial_n}")
    t0 = time.perf_counter()
    launch_instances(app, args.serial_n, scheduler="serial",
                     device=args.device)
    dts = time.perf_counter() - t0
    per = dts / args.serial_n
    print(f"   total {dts:.3f}s  rate {args.serial_n / dts:.1f} inst/s  "
          f"({per * 1e3:.0f} ms/instance)")
    print(f"   projected for n={args.n}: {per * args.n:.0f}s  "
          f"-> array launch is ~{per * args.n / dt:,.0f}x faster")

    print("== paper-scale model (16,384 instances on 256 KNL nodes)")
    h = headline()
    print(f"   llmr+wine:   {h['minutes']:.1f} min   "
          f"({h['rate_per_s']:.0f} inst/s; paper claims ~5 min)")
    for name, fn in CURVES.items():
        if name != "wine-llmr":
            print(f"   {name:20s} {fn(16384) / 60:10.0f} min")


if __name__ == "__main__":
    main()
