"""Mamba2 (arXiv:2405.21060, the SSD layer) in float32.

A block is x + W_out · norm(y · silu(z)), with x, z, B, C, dt projected from
rmsnorm(x); x, B and C pass a causal depthwise conv of 4 taps and silu;
dt = softplus(dt_raw + dt_bias); the scan is h_t = exp(dt_t A) h_{t-1} +
dt_t x_t ⊗ B_t, y_t = C_t · h_t + D x_t, computed here in chunks of
``CHUNK`` rows (exact: the in-chunk part as one masked product, the state
carried from chunk to chunk). The embedding is tied to the output head.
"""
from __future__ import annotations

from typing import List

import torch

from benchkit.reference.common import exact_f32, mm, rms, silu, stacked

CHUNK = 64


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """x (L, C), taps w (K, C): out[t] = sum_i x[t - K + 1 + i] w[i] + b."""
    K = w.shape[0]
    xp = torch.cat([x.new_zeros((K - 1, x.shape[1])), x], 0)
    return sum(xp[i:i + x.shape[0]] * w[i].float()
               for i in range(K)) + b.float()


def ssd(x, dt, A, B, C):
    """x (L,H,P), dt (L,H), A (H,), B/C (L,N) -> y (L,H,P), no D term."""
    L, H, P = x.shape
    h = x.new_zeros((H, P, B.shape[1]))
    ys = []
    for lo in range(0, L, CHUNK):
        xs, ds = x[lo:lo + CHUNK], dt[lo:lo + CHUNK]
        Bs, Cs = B[lo:lo + CHUNK], C[lo:lo + CHUNK]
        Q = xs.shape[0]
        cum = torch.cumsum(ds * A, 0)                          # (Q,H)
        diff = cum[:, None, :] - cum[None, :, :]               # (l,s,H)
        causal = torch.ones(Q, Q, dtype=torch.bool,
                            device=x.device).tril()
        decay = torch.exp(diff.masked_fill(~causal[..., None],
                                           float("-inf")))
        M = (Cs @ Bs.T)[..., None] * decay * ds[None]          # (l,s,H)
        y = torch.einsum("lsh,shp->lhp", M, xs)
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "ln,hpn->lhp", Cs, h)
        tail = torch.exp(cum[-1][None] - cum) * ds             # (s,H)
        h = torch.exp(cum[-1])[:, None, None] * h + torch.einsum(
            "sh,shp,sn->hpn", tail, xs, Bs)
        ys.append(y)
    return torch.cat(ys, 0)


def mixer(p: dict, x: torch.Tensor, spec: dict, fp8: bool, eps: float):
    P = spec["headdim"]
    xz = mm(x, p["w_x"], fp8=fp8)
    z = mm(x, p["w_z"], fp8=fp8)
    Bm = mm(x, p["w_B"], fp8=fp8)
    Cm = mm(x, p["w_C"], fp8=fp8)
    dt = torch.nn.functional.softplus(mm(x, p["w_dt"], fp8=fp8)
                                      + p["dt_bias"].float())
    cx = silu(causal_conv(xz, p["conv_x"], p["conv_bias_x"]))
    cB = silu(causal_conv(Bm, p["conv_B"], p["conv_bias_B"]))
    cC = silu(causal_conv(Cm, p["conv_C"], p["conv_bias_C"]))
    L, Di = cx.shape
    xh = cx.reshape(L, Di // P, P)
    A = -torch.exp(p["A_log"].float())
    y = ssd(xh, dt, A, cB, cC) + p["D"].float()[None, :, None] * xh
    y = y.reshape(L, Di) * silu(z)
    y = rms(y, p["norm"], eps)
    return mm(y, p["w_out"], fp8=fp8)


@torch.no_grad()
def logits(params: dict, cfg: dict, tokens: torch.Tensor,
           rows: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """The logits (len(rows), V) at positions ``rows`` of one sequence
    ``tokens`` (L,), in float32."""
    eps, gated_eps = cfg["norm_epsilon"], cfg["gated_norm_epsilon"]
    with exact_f32():
        x = params["embed"]["embedding"][tokens.long()].float()
        g = params["groups"][0]["stacked"]["0"]
        for r in range(cfg["n_layer"]):
            p = stacked(g, r)
            x = x + mixer(p["ssm"], rms(x, p["norm_ssm"]["scale"], eps),
                          cfg["ssm_cfg"], fp8, gated_eps)
        h = rms(x[rows], params["final_norm"]["scale"], eps)
        return mm(h, params["embed"]["embedding"].T, fp8=fp8)


def batch_logits(params, cfg, seqs: List[torch.Tensor], rows, fp8=False):
    return [logits(params, cfg, s, r, fp8) for s, r in zip(seqs, rows)]
