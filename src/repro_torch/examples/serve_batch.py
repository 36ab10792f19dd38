"""Interactive serving: load a model as a Wine application and stream
batched decode requests — the paper's 'interactive supercomputing' use
case with models instead of Windows apps. Port of the reference's
``examples/serve_batch.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_batch
        [--arch qwen3-14b] [--batch 8] [--prompt-len 32] [--gen-len 32]
        [--device cpu]

The model is the architecture's smoke config with random weights drawn
from a seeded ``torch.Generator``. One prefill fills the batch's KV rings;
the decode step goes through the Wine adapter's backend
(``backend.compile``, the rings and weights bound at their addresses): on
the card a CUDA graph captured on the first step and replayed for every
later one, its source printed. Runs on the card unless ``--device cpu`` is
given; without a card and without ``--device cpu`` it fails.
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.wine import WineAdapter
from repro_torch.launch.serve import init_params
from repro_torch.models.lm import cache_init, decode_step, prefill


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=True)
    adapter = WineAdapter(device=args.device)
    dev = adapter.device

    # Wine env setup: load the architecture as a uniform 'application'
    t0 = time.perf_counter()
    params = init_params(cfg, dev, seed=0)
    _sync(dev)
    print(f"loaded {args.arch} (smoke config) in "
          f"{time.perf_counter() - t0:.2f}s")

    B = args.batch
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (B, args.prompt_len),
                            generator=gen, device=dev, dtype=torch.int32)
    capacity = args.prompt_len + args.gen_len

    t0 = time.perf_counter()
    logits, caches = prefill(params, {"tokens": prompts}, cfg,
                             capacity=capacity)
    _sync(dev)
    print(f"prefill {B}x{args.prompt_len} in {time.perf_counter() - t0:.2f}s")

    def step_fn(p, c, t, po):
        return decode_step(p, c, t, po, cfg)[0]

    tok = torch.argmax(logits, -1).to(torch.int32)
    pos = torch.full((B, 1), args.prompt_len, dtype=torch.int32, device=dev)
    dstep, source = adapter.backend.compile(
        step_fn, (params, caches, tok, pos), bind_argnums=(0, 1),
        extras=("serve-batch", cfg.name, B, capacity))
    out_tokens = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen_len - 1):
        pos = torch.full((B, 1), args.prompt_len + i, dtype=torch.int32,
                         device=dev)
        logits = dstep(params, caches, tok, pos)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out_tokens.append(tok)
    _sync(dev)
    dt = time.perf_counter() - t0
    total = B * (args.gen_len - 1)
    print(f"decoded {total} tokens in {dt:.2f}s "
          f"({total / dt:,.0f} tok/s batched)")
    st = adapter.cache.stats
    print(f"decode step: {source} ({st['captures']} capture, "
          f"{st['replays']} replays on {dev})")
    gen_toks = torch.cat(out_tokens, dim=1)
    print("sample generation (token ids):", gen_toks[0, :12].tolist())
    return gen_toks


if __name__ == "__main__":
    main()
