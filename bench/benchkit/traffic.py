"""One general generator of traffic from a mix's parameters.

An open-loop mix (``"loop": "open_loop"``) gives an arrival rate, a law
for prompt lengths and one for output lengths. The schedule — each
request's arrival, prompt length and output length, in order — is drawn
from the mix's own ``template_seed``, so it is the same for every run seed
of the same length; the run's seed draws the prompts' token ids. Two
seeds thus offer the same work at the same times with other tokens, and
the spread between runs is the system's, not the generator's. Arrivals
are Poisson (exponential gaps). A length law is ``{"choices": [...],
"weights": [...]}``, ``{"uniform": [lo, hi]}``, or ``{"lognormal":
{"median": m, "sigma": s}, "clip": [lo, hi]}`` (rounded to whole tokens,
then clipped).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List

import numpy as np


@dataclass(eq=False)
class Req:
    rid: int
    due: float                  # seconds after the loop's start
    prompt: np.ndarray          # int32 token ids
    max_new: int
    # stamps the loop writes (perf_counter seconds)
    t_due: float = 0.0
    t_placed: float = None
    engine_req: object = field(default=None, repr=False)


def _lengths(law: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    if "choices" in law:
        p = np.asarray(law.get("weights", [1] * len(law["choices"])), float)
        return rng.choice(np.asarray(law["choices"]), size=n, p=p / p.sum())
    if "lognormal" in law:
        ln = law["lognormal"]
        x = rng.lognormal(math.log(ln["median"]), ln["sigma"], size=n)
        return np.clip(np.rint(x).astype(np.int64), *law["clip"])
    lo, hi = law["uniform"]
    return rng.integers(lo, hi + 1, size=n)


def possible_lengths(law: dict) -> List[int]:
    """Every prompt length the law can draw."""
    if "choices" in law:
        return sorted(set(int(c) for c in law["choices"]))
    lo, hi = law["clip"] if "lognormal" in law else law["uniform"]
    return list(range(lo, hi + 1))


def count_for(mix: dict, seconds: float) -> int:
    """Requests a run of ``seconds`` (after the mix's warm-up) is offered:
    enough that the generator never runs dry before the window closes."""
    span = mix["warmup_s"] + seconds
    return int(math.ceil(mix["rate_per_s"] * span * 1.25)) + 16


def open_loop(mix: dict, seed: int, seconds: float, vocab: int) -> List[Req]:
    """The requests of one run, in order of their due times."""
    n = count_for(mix, seconds)
    tpl = np.random.default_rng(int(mix["template_seed"]))
    prompt_len = _lengths(mix["prompt_len"], tpl, n)
    out_len = _lengths(mix["output_len"], tpl, n)
    gaps = tpl.exponential(1.0 / mix["rate_per_s"], size=n)
    due = np.cumsum(gaps)
    rng = np.random.default_rng(int(seed))
    reqs = []
    for i in range(n):
        toks = rng.integers(0, vocab, size=int(prompt_len[i]), dtype=np.int64)
        reqs.append(Req(rid=i, due=float(due[i]),
                        prompt=toks.astype(np.int32),
                        max_new=int(out_len[i])))
    return reqs

