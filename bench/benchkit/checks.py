"""What decides ``correct`` for a served model.

Once the window has closed, a sample of the finished requests, drawn from
the seed and always holding the longest, is run through the plain
reference once each: prompt and served tokens, teacher-forced. At every
position that produced a served token, the gap is how far the served
token's reference logit lies below the reference's best there; the number
compared is the widest gap. Greedy decoding of the reference's own logits
would read 0; the program's bf16 arithmetic reads the gaps of its near
ties. The control reads the same gaps for the token that the reference
computed through float8 puts first at each position. A cell's limits file
(``bench/limits/<cell>.json``) names the numbers it compares: the widest
gap, or where the widest gap cannot separate sound runs from the control
the mean gap over the tokens compared.
"""
from __future__ import annotations

import importlib
from typing import List

import numpy as np
import torch


def sample(done: list, k: int, seed: int) -> list:
    """``k`` of the finished requests: the longest (prompt and output) and
    ``k - 1`` drawn from the seed."""
    if not done or k <= 0:
        return []
    longest = max(done, key=lambda r: len(r.prompt) + len(r.engine_req.out))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed), 7919])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def sequences(reqs: list, device):
    """(teacher-forced inputs, the rows that produced each served token,
    the served tokens) of each request."""
    seqs, rows, served = [], [], []
    for r in reqs:
        out = list(r.engine_req.out)
        n = len(r.prompt)
        seqs.append(torch.as_tensor(np.concatenate(
            [r.prompt, np.asarray(out[:-1], np.int32)]).astype(np.int64),
            device=device))
        rows.append(torch.arange(n - 1, n - 1 + len(out), device=device))
        served.append(torch.as_tensor(out, device=device))
    return seqs, rows, served


def gaps(ref: List[torch.Tensor], tokens: List[torch.Tensor]) -> np.ndarray:
    """Every position's gap: the reference's best logit less its logit of
    the token at that position."""
    out = []
    for lg, tok in zip(ref, tokens):
        best = lg.max(-1).values
        out.append((best - lg.gather(-1, tok.long()[:, None])[:, 0]).cpu())
    return torch.cat(out).double().numpy()


def reference(family_module) -> object:
    return importlib.import_module(
        f"benchkit.reference.{family_module.REFERENCE}")


def summary(g: np.ndarray) -> dict:
    """The widest gap (``logit_gap``) and the mean gap
    (``mean_logit_gap``), with the 99th percentile, the count of tokens
    compared and the share the reference ranks first."""
    if not len(g):
        return {"logit_gap": float("nan"), "mean_logit_gap": float("nan"),
                "tokens": 0, "top1_share": 0.0}
    return {"logit_gap": float(g.max()), "mean_logit_gap": float(g.mean()),
            "p99_gap": float(np.percentile(g, 99)), "tokens": int(len(g)),
            "top1_share": float((g == 0).mean())}


def served_gap(params, cfg: dict, fam, reqs: list, device,
               control: bool = False) -> dict:
    """``summary`` of the gaps of the served tokens of ``reqs``; with
    ``control``, also the control's: at the same positions, the gaps of
    the tokens that the reference computed through float8 puts first."""
    ref = reference(fam)
    seqs, rows, served = sequences(reqs, device)
    exact = ref.batch_logits(params, cfg, seqs, rows)
    out = summary(gaps(exact, served))
    if control:
        low = ref.batch_logits(params, cfg, seqs, rows, fp8=True)
        out["control"] = summary(gaps(exact, [x.argmax(-1) for x in low]))
    return out
