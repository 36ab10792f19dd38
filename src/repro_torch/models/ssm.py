"""Mamba2 (state-space duality) mixer. Port of ``repro.models.ssm``.

Prefill uses the chunked SSD algorithm (``ssd_chunked``), computed by the
hand-written CUDA kernel of ``kernels.ssd_scan`` on the card and by its
plain version on the CPU. Decode is the O(1) recurrent update. Projections
are separate weights (x/z/B/C/dt), as in the reference.

The cache is ``{conv_x, conv_B, conv_C, state}``. It is updated IN PLACE,
like the attention caches (``models.attention``). A cache may carry
``live`` (B,) bool beside its leaves: a row whose ``live`` is False keeps
its old leaves, so a stalled slot's retried step is identical (the
recurrence must not absorb the same token twice).

bf16 rounding follows eager JAX op for op: the causal conv adds its taps in
bf16 in the reference's order, the decode conv sums its window in f32 and
rounds once (as ``jnp.sum`` does for bf16), silu is written out as JAX
lowers it, softplus is ``logaddexp(x, 0)``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.layers import fan_in_init, normal_init
from repro_torch.models.mlp import _silu
from repro_torch.models.spec import ModelConfig, SsmSpec
from repro_torch.sharding.partition import constrain
from repro_torch.sharding.spmd import einsum, matmul, pad, reshape


_SSM_CACHE_AXES = {
    "conv_x": ("cache_batch", None, "d_inner"),
    "conv_B": ("cache_batch", None, "state"),
    "conv_C": ("cache_batch", None, "state"),
    "state": ("cache_batch", "ssm_heads", "head_dim", "state"),
}


def _constrain_cache(cache: dict) -> dict:
    return {k: constrain(v, *_SSM_CACHE_AXES[k]) for k, v in cache.items()}


def ssm_dims(d_model: int, spec: SsmSpec):
    d_inner = spec.expand * d_model
    n_heads = d_inner // spec.head_dim
    return d_inner, n_heads


def ssm_init(gen, d_model: int, spec: SsmSpec, cfg: ModelConfig,
             device) -> dict:
    d_inner, H = ssm_dims(d_model, spec)
    G, N = spec.n_groups, spec.d_state
    dt, f32 = torch.bfloat16, torch.float32

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "w_x": fan_in_init(gen, (d_model, d_inner), d_model, dt, device),
        "w_z": fan_in_init(gen, (d_model, d_inner), d_model, dt, device),
        "w_B": fan_in_init(gen, (d_model, G * N), d_model, dt, device),
        "w_C": fan_in_init(gen, (d_model, G * N), d_model, dt, device),
        "w_dt": fan_in_init(gen, (d_model, H), d_model, dt, device),
        "conv_x": normal_init(gen, (spec.d_conv, d_inner), 0.1, dt, device),
        "conv_B": normal_init(gen, (spec.d_conv, G * N), 0.1, dt, device),
        "conv_C": normal_init(gen, (spec.d_conv, G * N), 0.1, dt, device),
        "conv_bias_x": full((d_inner,), 0.0, dt),
        "conv_bias_B": full((G * N,), 0.0, dt),
        "conv_bias_C": full((G * N,), 0.0, dt),
        "dt_bias": full((H,), 0.0, f32),
        "A_log": full((H,), 0.0, f32),               # A = -exp(A_log) = -1
        "D": full((H,), 1.0, f32),
        "norm": full((d_inner,), 1.0, dt),
        "w_out": fan_in_init(gen, (d_inner, d_model), d_inner, dt, device),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: (B,S,C), w: (K,C) -> (B,S,C)."""
    K = w.shape[0]
    xp = pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(K))
    return out + b


def _gated_norm(scale, y, z, eps=1e-6):
    y = y * _silu(z.float())
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    return y * torch.rsqrt(var + eps) * scale.float()


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD scan. xh: (B,S,H,P), dt: (B,S,H), A: (H,), Bm/Cm: (B,S,N)
    (n_groups=1). Returns y: (B,S,H,P) f32, final_state: (B,H,P,N) f32."""
    return ssd_scan(xh, dt, A, Bm, Cm, chunk=chunk, out_dtype=torch.float32,
                    return_state=True)


def ssm_cache_init(batch: int, d_model: int, spec: SsmSpec, device) -> dict:
    d_inner, H = ssm_dims(d_model, spec)
    GN = spec.n_groups * spec.d_state
    bf = dict(dtype=torch.bfloat16, device=device)
    return {
        "conv_x": torch.zeros((batch, spec.d_conv - 1, d_inner), **bf),
        "conv_B": torch.zeros((batch, spec.d_conv - 1, GN), **bf),
        "conv_C": torch.zeros((batch, spec.d_conv - 1, GN), **bf),
        "state": torch.zeros((batch, H, spec.head_dim, spec.d_state),
                             dtype=torch.float32, device=device),
    }


def _write(cache: dict, new: dict) -> None:
    """Store ``new`` leaves into ``cache`` in place; rows whose ``live``
    is False keep their old leaves (gated before the write)."""
    live = cache.get("live")
    for k, v in new.items():
        old = cache[k]
        v = v.to(old.dtype)
        if live is not None:
            v = torch.where(live.reshape((-1,) + (1,) * (old.ndim - 1)), v,
                            old)
        old.copy_(v)


def ssm_apply(params: dict, x: torch.Tensor, spec: SsmSpec, cfg: ModelConfig,
              positions, cache: Optional[dict] = None) -> torch.Tensor:
    """x: (B,S,D) -> y (B,S,D); ``cache`` is updated in place."""
    B, S, D = x.shape
    d_inner, H = ssm_dims(D, spec)
    P = spec.head_dim
    A = -torch.exp(params["A_log"])

    xz = constrain(matmul(x, params["w_x"]), "batch", "seq", "d_inner")
    z = constrain(matmul(x, params["w_z"]), "batch", "seq", "d_inner")
    Bm = matmul(x, params["w_B"])
    Cm = matmul(x, params["w_C"])
    dt_raw = matmul(x, params["w_dt"]).float()
    v = dt_raw + params["dt_bias"]
    dt = torch.logaddexp(v, torch.zeros_like(v))               # softplus

    if cache is not None and S == 1:
        # ---- decode: O(1) recurrence
        def conv(hist, w, b):
            return _silu((hist * w[None]).float().sum(1).to(hist.dtype) + b)

        hist_x = torch.cat([cache["conv_x"], xz], dim=1)
        hist_B = torch.cat([cache["conv_B"], Bm], dim=1)
        hist_C = torch.cat([cache["conv_C"], Cm], dim=1)
        cx = conv(hist_x, params["conv_x"], params["conv_bias_x"])
        cB = conv(hist_B, params["conv_B"], params["conv_bias_B"])
        cC = conv(hist_C, params["conv_C"], params["conv_bias_C"])
        xh = reshape(cx, (B, H, P)).float()
        dt1 = dt[:, 0]                                         # (B,H)
        decay = torch.exp(dt1 * A)                             # (B,H)
        h = cache["state"] * decay[:, :, None, None] + (
            (dt1[:, :, None] * xh)[..., None]
            * cB.float()[:, None, None, :])
        y = einsum("bn,bhvn->bhv", cC.float(), h)
        y = y + params["D"][None, :, None] * xh
        y = reshape(y, (B, 1, d_inner))
        _write(cache, _constrain_cache({
            "conv_x": hist_x[:, 1:], "conv_B": hist_B[:, 1:],
            "conv_C": hist_C[:, 1:], "state": h}))
    else:
        # ---- prefill: chunked SSD
        cx = _silu(_causal_conv(xz, params["conv_x"], params["conv_bias_x"]))
        cB = _silu(_causal_conv(Bm, params["conv_B"], params["conv_bias_B"]))
        cC = _silu(_causal_conv(Cm, params["conv_C"], params["conv_bias_C"]))
        xh = reshape(cx, (B, S, H, P))
        y, h_final = ssd_chunked(xh, dt, A, cB, cC, spec.chunk)
        y = y + params["D"][None, None, :, None] * xh.float()
        y = reshape(y, (B, S, d_inner))
        if cache is not None:
            k = spec.d_conv - 1
            _write(cache, _constrain_cache({
                "conv_x": xz[:, -k:], "conv_B": Bm[:, -k:],
                "conv_C": Cm[:, -k:], "state": h_final}))

    y = _gated_norm(params["norm"], y, z)
    return matmul(y.to(x.dtype), params["w_out"])
