"""The ``mla`` route of the port's paged attention: deepseek-v2's absorbed
form (H 128 query heads over one latent head, q.ckv over Dk 512 plus
q_rope.kr over Dk2 64, values the same ckv pool, so ``v`` is ``k``).

``_emulate_mla`` repeats the route's rounding points in plain PyTorch: the
slot's keys in table order in tiles of 32 (``MLA_KEYS``), bf16 q.k and
q2.k2 products summed in f32, scale, softcap and mask in f32, an f32 online
softmax a tile, P split into P_hi = bf16(p) and P_lo = bf16(p - P_hi)
before the f32 P @ V (each warpgroup's 256-column half of the accumulator
is just its columns: no rounding of its own), each split's (m, l, acc)
joined as ``paged_combine_kernel`` joins them, and one rounding of the
output. It must stay within one bf16 rounding of the f32 answer (atol
1e-5, rtol 2^-8: ``ONE_ROUNDING``) for every split count, on a problem
with dead entries mid-table, a part-filled last page, a pad query row and
an all-dead slot (exact zeros); rounding P once to bf16 must fail that
limit. The routing tests hold ``_route`` to the rules of the ``mla``
route from shapes alone. The ``cuda`` tests hold the kernel on the card
against the f32 answer over the same odd cases and split counts, and at
deepseek-v2's serving shapes: ``python -m pytest --noconftest -m cuda
tests/test_torch_paged_mla.py``. JAX is imported inside the one test that
compares the plain version with the reference's oracle.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.paged_attention import (MLA_KEYS, Smem,
                                                 _library_smem, _route,
                                                 paged_attention,
                                                 paged_attention_ref)
from test_torch_paged_attention import (ALL_FIT, N_SM, ONE_ROUNDING, _call,
                                        _f32_answer, _mk, _torch_args,
                                        _visible, cuda_device)

# one intra-op thread: the suite runs many test processes side by side
torch.set_num_threads(1)

MLA_SCALE = 1.0 / math.sqrt(128 + 64)          # 1/sqrt(dn + dr)
H, DK, DK2, PS = 128, 512, 64, 16              # deepseek-v2's widths


def _odd(seed=29):
    """A small MLA problem at deepseek-v2's head count with every odd case
    of the route (numpy; k = v = one ckv pool): 3 slots of 6 table entries
    of 16-row pages (3 key tiles of 32), 2 query rows each (R = 256: four
    row tiles). Slot 0: dead entries mid-table and a last page filled to 5
    rows, its queries at the last two positions (the first does not see
    the last key). Slot 1: all entries dead (exact zeros). Slot 2: a full
    table but for entry 4, and a pad query row (q_pos -1: exact zeros)."""
    r = np.random.default_rng(seed)
    P, npps, B, S = 12, 6, 3, 2
    kv = r.standard_normal((P, PS, 1, DK), np.float32)
    k2 = r.standard_normal((P, PS, 1, DK2), np.float32)
    pages = r.permutation(P)
    tables = np.full((B, npps), -1, np.int32)
    kpos = np.full((P, PS), -1, np.int32)
    layout = {0: [(0, PS), (2, PS), (3, 5)],
              2: [(0, PS), (1, PS), (2, PS), (3, PS), (5, PS)]}
    n = 0
    for b, entries in layout.items():
        for j, rows in entries:
            tables[b, j] = pages[n]
            kpos[pages[n], :rows] = j * PS + np.arange(rows)
            n += 1
    q_pos = np.array([[51, 52], [0, 0], [95, -1]], np.int32)
    return dict(q=r.standard_normal((B, S, H, DK), np.float32), k=kv, v=kv,
                kpos=kpos, tables=tables, q_pos=q_pos,
                q2=r.standard_normal((B, S, H, DK2), np.float32), k2=k2)


def _mla_args(a, device="cpu", dtype=torch.bfloat16):
    """``_torch_args`` with ``v`` the very tensor ``k``, as the model
    passes the ckv pool."""
    t = _torch_args(dict(a, v=None), device, dtype)
    t["v"] = t["k"]
    return t


def _emulate_mla(a, splits, *, split_p=True, scale=MLA_SCALE, causal=True,
                 window=None, softcap=None):
    """The mla route's rounding points (module docstring), the table cut
    into ``splits`` ranges of whole 32-key tiles (as ``_plan`` cuts it:
    ``per`` = ceil(tiles / splits) tiles a range). ``split_p`` False rounds
    p once to bf16 before P @ V: the control."""
    q, kv, kpos, tables, q_pos, q2, k2 = (a[n] for n in (
        "q", "k", "kpos", "tables", "q_pos", "q2", "k2"))
    B, S, Hq, Dk = q.shape
    P, ps, K, _ = kv.shape
    G, npps = Hq // K, tables.shape[1]
    keys = npps * ps
    tiles = -(-keys // MLA_KEYS)
    per = -(-tiles // splits)
    cl = tables.clamp(min=0).long()
    live = (tables >= 0).repeat_interleave(ps, dim=1)            # (B, keys)
    kd = torch.where(live[..., None, None],
                     kv[cl].reshape(B, keys, K, Dk).float(), 0.0)
    k2d = torch.where(live[..., None, None],
                      k2[cl].reshape(B, keys, K, -1).float(), 0.0)
    kp = torch.where(live, kpos[cl].reshape(B, -1), -1)
    qg = q.float().reshape(B, S, K, G, Dk)
    q2g = q2.float().reshape(B, S, K, G, -1)
    parts = []
    for sp in range(-(-tiles // per)):
        m = torch.full((B, S, K, G, 1), -1e30)
        l = torch.zeros((B, S, K, G, 1))
        acc = torch.zeros((B, S, K, G, Dk))
        for n in range(sp * per, min(tiles, sp * per + per)):
            t = slice(n * MLA_KEYS, (n + 1) * MLA_KEYS)
            s = (torch.einsum("bskgd,bpkd->bskgp", qg, kd[:, t])
                 + torch.einsum("bskgd,bpkd->bskgp", q2g, k2d[:, t])) * scale
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            vis = _visible(kp[:, t], q_pos, causal, window)[:, :, None, None]
            s = torch.where(vis, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.where(vis, torch.exp(s - m_new), 0.0)
            l = l * alpha + p.sum(-1, keepdim=True)
            hi = p.to(torch.bfloat16).float()
            pv = torch.einsum("bskgp,bpkd->bskgd", hi, kd[:, t])
            if split_p:
                pv = pv + torch.einsum("bskgp,bpkd->bskgd",
                                       (p - hi).to(torch.bfloat16).float(),
                                       kd[:, t])
            acc = acc * alpha + pv
            m = m_new
        parts.append((m, l, acc))
    if len(parts) == 1:                   # unsplit: the block divides
        m, l, acc = parts[0]
        out = acc / torch.where(l > 0, l, 1.0)
    else:                                 # paged_combine_kernel
        M, L, A = (torch.stack(x) for x in zip(*parts))
        ok = L > 0
        mx = torch.where(ok, M, -math.inf).amax(0)
        w = torch.where(ok, torch.exp(M - mx), 0.0)
        den = (w * L).sum(0)
        out = ((w * torch.where(ok, A, 0.0)).sum(0)
               / torch.where(den > 0, den, 1.0))
    return out.reshape(B, S, Hq, Dk).to(torch.bfloat16)


def _tiles(a):
    return -(-a["tables"].shape[1] * a["k"].shape[1] // MLA_KEYS)


@pytest.mark.parametrize("splits", [1, 2, 3])
def test_mla_emulation_within_one_bf16_rounding(splits):
    """For every split count of the odd problem: within one bf16 rounding
    of the f32 answer; the all-dead slot and the pad query row are exact
    zeros."""
    a = _mla_args(_odd())
    assert _tiles(a) == 3
    out = _emulate_mla(a, splits)
    torch.testing.assert_close(out.float(), _f32_answer(a, scale=MLA_SCALE),
                               **ONE_ROUNDING)
    assert bool((out[1] == 0).all()) and bool((out[2, 1] == 0).all())
    assert bool((out[0] != 0).any()) and bool((out[2, 0] != 0).any())


@pytest.mark.parametrize("kw", [dict(softcap=30.0), dict(window=40)],
                         ids=["softcap", "window"])
def test_mla_emulation_with_softcap_and_window(kw):
    """The route takes softcap and window like every other route."""
    a = _mla_args(_odd(30))
    for splits in (1, 3):
        torch.testing.assert_close(
            _emulate_mla(a, splits, **kw).float(),
            _f32_answer(a, scale=MLA_SCALE, **kw), **ONE_ROUNDING)


def test_mla_emulation_single_bf16_p_fails_one_rounding():
    """The control, and why P is split: p rounded once to bf16 before
    P @ V does not hold that limit."""
    a = _mla_args(_odd())
    exact = _f32_answer(a, scale=MLA_SCALE)
    for splits in (1, 3):
        single = _emulate_mla(a, splits, split_p=False).float()
        assert int((~torch.isclose(single, exact, **ONE_ROUNDING)).sum()) > 0


def test_mla_plain_matches_reference_oracle():
    """The port's paged call on the odd problem (its plain version on the
    CPU, f32) against the reference's oracle: atol = rtol = 2e-5."""
    import jax.numpy as jnp
    from repro.kernels.ref import paged_attention_ref as jref
    a = _odd()
    j = np.asarray(_call(jref, {k: jnp.asarray(x) for k, x in a.items()},
                         scale=MLA_SCALE))
    t = _call(paged_attention, _mla_args(a, dtype=torch.float32),
              scale=MLA_SCALE).numpy()
    np.testing.assert_allclose(t, j, atol=2e-5, rtol=2e-5)
    assert np.all(t[1] == 0.0) and np.all(t[2, 1] == 0.0)


# deepseek-v2's paged shapes (tests/test_torch_mla.py's FULL_MLA): 4 slots,
# 16-row pages; decode over 32 entries, a 128-token prefill, a decode over
# 256 entries; (S, npps, want splits on 132 SMs)
FULL_SHAPES = [("decode", 1, 32, 16), ("prefill", 128, 32, 1),
               ("long_decode", 1, 256, 16)]


def _full(S, npps, dtype=torch.bfloat16, Dk=DK, Dk2=DK2, ps=PS, heads=H):
    q = torch.empty((4, S, heads, Dk), dtype=dtype)
    kv = torch.empty((1024, ps, 1, Dk), dtype=dtype)
    return dict(q=q, k=kv, v=kv, q2=torch.empty((4, S, heads, Dk2),
                                                dtype=dtype),
                k2=torch.empty((1024, ps, 1, Dk2), dtype=dtype),
                tables=torch.empty((4, npps), dtype=torch.int32))


def _route_of(t, smem=ALL_FIT, n_sm=N_SM):
    return _route(t["q"], t["k"], t["v"], t["q2"], t["tables"], n_sm, smem)


@pytest.mark.parametrize("name,S,npps,splits", FULL_SHAPES,
                         ids=[c[0] for c in FULL_SHAPES])
def test_route_takes_mla_at_deepseek_shapes(name, S, npps, splits):
    """bf16 at deepseek-v2's three shapes goes ``mla``: decodes split the
    table into 16 ranges of whole key tiles (8 row tiles x 16 = 128 blocks
    on 132 SMs), the prefill's 1,024 row tiles run unsplit; f32 goes
    ``general``."""
    t = _full(S, npps)
    assert _route_of(t) == "mla"
    route, got, per, ws = pa._plan(pa._shape(t["q"], t["k"], t["v"],
                                             t["q2"], t["tables"]),
                                   N_SM, ALL_FIT)
    tiles = npps * PS // MLA_KEYS
    assert (route, got) == ("mla", splits)
    assert (got - 1) * per < tiles <= got * per
    assert ws == (4 * got * S * H * (DK + 2) if got > 1 else 0)
    assert _route_of(_full(S, npps, torch.float32)) == "general"


def test_route_takes_mla_only_where_v_is_k():
    """``v`` another tensor than ``k`` (or a copy of it) goes ``general``;
    a second view of the same storage and shape is the same tensor."""
    t = _full(128, 32)
    assert _route_of(dict(t, v=t["k"].clone())) == "general"
    assert _route_of(dict(t, v=t["k"].view(t["k"].shape))) == "mla"


@pytest.mark.parametrize("kw", [dict(Dk=448), dict(Dk=128), dict(Dk2=8),
                                dict(ps=8), dict(ps=64), dict(heads=64)],
                         ids=["dk448", "dk128", "dk2_8", "ps8", "ps64",
                              "g64"])
def test_route_takes_mla_at_other_widths(kw):
    assert _route_of(_full(128, 32, **kw)) == "mla"


@pytest.mark.parametrize("kw", [dict(Dk=576), dict(Dk=96), dict(Dk2=72),
                                dict(Dk2=4), dict(ps=4), dict(ps=12)],
                         ids=["dk576", "dk96", "dk2_72", "dk2_4", "ps4",
                              "ps12"])
def test_route_leaves_mla_out_beyond_its_widths(kw):
    """Dk past 512 or not a multiple of 64, Dk2 past 64 or not a multiple
    of 8, pages under 8 rows or not a power of two: ``general``."""
    assert _route_of(_full(128, 32, **kw)) == "general"


def test_route_at_deepseek_smoke_width():
    """deepseek-v2-smoke (4 heads, kv_lora_rank 32): its decode (R = 4)
    splits as before, its prefill (Dk 32) takes the general kernel."""
    assert _route_of(_full(1, 32, Dk=32, heads=4)) == "split"
    assert _route_of(_full(128, 32, Dk=32, heads=4)) == "general"


def test_mla_splits_follow_the_sm_count():
    """The ranges of key tiles come from shapes and the SM count alone:
    about one block an SM, none empty, at most one range a tile."""
    t = _full(1, 256)
    for n_sm, want in [(8, 1), (16, 2), (132, 16), (1024, 128),
                       (4096, 128)]:
        shape = pa._shape(t["q"], t["k"], t["v"], t["q2"], t["tables"])
        route, splits, per, _ = pa._plan(shape, n_sm, ALL_FIT)
        assert (route, splits) == ("mla", want), n_sm
        assert (splits - 1) * per < 128 <= splits * per


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("kw", [{}, dict(softcap=30.0), dict(window=40)],
                         ids=["plain", "softcap", "window"])
def test_cuda_mla_odd_cases_within_one_rounding(cuda_device, monkeypatch,
                                                kw, splits):
    """The kernel on the odd problem at every split count (the SM count
    ``_plan`` sees set so that the 12 row-tile blocks split the 3 key tiles
    ``splits`` ways): on the ``mla`` route, within one bf16 rounding of the
    f32 answer and within 2e-2 / 1e-2 of the plain version in bf16 (one
    bf16 rounding of the output on each side); the all-dead slot and the
    pad row are exact zeros."""
    monkeypatch.setattr(pa, "_n_sm", lambda index: 12 * splits)
    a = _mla_args(_odd(), cuda_device)
    shape = pa._shape(a["q"], a["k"], a["v"], a["q2"], a["tables"])
    assert pa._plan(shape, 12 * splits, _library_smem())[:2] == ("mla",
                                                                 splits)
    routes = dict(paged_attention.routes)
    out = _call(paged_attention, a, scale=MLA_SCALE, **kw)
    torch.cuda.synchronize()
    assert paged_attention.routes["mla"] == routes["mla"] + 1
    exact = _f32_answer(a, scale=MLA_SCALE, **kw)
    torch.testing.assert_close(out.float(), exact, **ONE_ROUNDING)
    ref = _call(paged_attention_ref, a, scale=MLA_SCALE, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=1e-2)
    assert bool((out[1] == 0).all()) and bool((out[2, 1] == 0).all())


# other widths the route takes: Dk of 1, 3 and 7 boxes (a warpgroup's last
# value box the kr box where the count is odd), q by TMA (G = 64) and by
# cp.async (G = 40: three row tiles of a 2 x 40 prefill, the last of 16
# rows), pages of 8, 16 and 64 rows, K = 2
WIDTHS = [
    ("dk64_g64_ps8", dict(B=2, S=2, H=64, K=1, Dk=64, q2dim=16, P=24, ps=8,
                          npps=10, filled=[10, 4])),
    ("dk192_g40_ps16", dict(B=2, S=3, H=40, K=1, Dk=192, q2dim=64, P=24,
                            ps=16, npps=6, filled=[6, 3])),
    ("dk448_g64_k2_ps64", dict(B=1, S=1, H=128, K=2, Dk=448, q2dim=32, P=8,
                               ps=64, npps=4, filled=[3])),
]


def _width_args(kw, device="cpu"):
    kw = dict(kw, Dv=kw["Dk"])
    return _mla_args(_mk(31, q_from_zero=kw["S"] > 1, **kw), device)


@pytest.mark.parametrize("name,kw", WIDTHS, ids=[w[0] for w in WIDTHS])
def test_mla_emulation_at_other_widths(name, kw):
    """These widths take the route, and its rounding design holds there
    for every split count."""
    a = _width_args(kw)
    assert _route_of(a) == "mla"
    for splits in range(1, _tiles(a) + 1):
        torch.testing.assert_close(
            _emulate_mla(a, splits).float(),
            _f32_answer(a, scale=MLA_SCALE), **ONE_ROUNDING)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", WIDTHS, ids=[w[0] for w in WIDTHS])
def test_cuda_mla_other_widths_within_one_rounding(cuda_device, name, kw):
    a = _width_args(kw, cuda_device)
    routes = dict(paged_attention.routes)
    out = _call(paged_attention, a, scale=MLA_SCALE)
    torch.cuda.synchronize()
    assert paged_attention.routes["mla"] == routes["mla"] + 1, name
    torch.testing.assert_close(out.float(), _f32_answer(a, scale=MLA_SCALE),
                               **ONE_ROUNDING)


@pytest.mark.cuda
def test_cuda_mla_route_fits_at_deepseek_shapes(cuda_device):
    """With the CUDA source's own shared-memory sizes the mla block fits
    at deepseek-v2's shapes (one block an SM), and each takes the route."""
    smem = _library_smem()
    for name, S, npps, _ in FULL_SHAPES:
        assert smem.mla(DK, npps, PS) <= smem.limit, name
        assert _route_of(_full(S, npps), smem) == "mla", name
    assert smem.mla(DK, 32, PS) > smem.limit // 2


@pytest.mark.cuda
def test_cuda_mla_rejects_unaligned_tensors(cuda_device):
    """The route takes tensors that start on 16-byte boundaries: a q2 cut
    8 bytes in raises, nothing falls back."""
    a = _mla_args(_odd(), cuda_device)
    flat = torch.empty(a["q2"].numel() + 4, dtype=torch.bfloat16,
                       device=cuda_device)
    q2 = flat[4:].view(a["q2"].shape)
    with pytest.raises(ValueError):
        paged_attention(a["q"], a["k"], a["v"], a["kpos"], a["tables"],
                        a["q_pos"], q2=q2, k2=a["k2"], scale=MLA_SCALE)
