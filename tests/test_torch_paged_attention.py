"""The port's paged attention against the reference's.

On the CPU the port's wrapper runs its plain version, which must agree with
the reference's Pallas kernel (interpret mode, ``block_q=8``, as the
reference's own tests run it) and with the reference oracle
``paged_attention_ref`` over the case grid of
``tests/test_paged_attention.py``. Tolerance: f32 atol = rtol = 2e-5, the
reference's own contract — the same math, summed in another order.

The kernels take one of four routes, chosen from shapes alone
(``_route``): ``split`` (S*G < 64), ``tile`` (bf16 prefill), ``mla`` (bf16
MLA with v the tensor k: ``tests/test_torch_paged_mla.py``) and
``general``.
``_emulate_split`` repeats the split route's arithmetic in plain PyTorch
(partials over ranges of table entries, then the combine) and must hold the
oracle's f32 contract for every split count; ``_emulate_tile`` repeats the
tile route's rounding points (bf16 q.k summed in f32, an f32 online softmax
over 64-key tiles gathered from pages, p split into two bf16 terms before
the f32 p @ v, one rounding of the output) and must stay within one bf16
rounding of the f32 answer (atol 1e-5, rtol 2^-8).

The ``cuda`` tests hold the CUDA kernels against the plain version on the
card (f32 2e-5; bf16 atol 2e-2, rtol 1e-2: one bf16 rounding of the output
on each side), check each case's route, and hold the bf16 serving shapes
within one rounding of the f32 answer. JAX is imported in a fixture, not at
module level, so that the file also runs where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_paged_attention.py``.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import (Smem, _library_smem,
                                                 _route, _splits,
                                                 paged_attention,
                                                 paged_attention_ref)

# one intra-op thread: the suite runs many test processes side by side
torch.set_num_threads(1)

ATOL = RTOL = 2e-5
ONE_ROUNDING = dict(atol=1e-5, rtol=2.0 ** -8)
N_SM = 132                                   # an H100's SMs
# shared memory that every route's block fits in: the routing rules alone
# (on the card, ``_library_smem`` gives the CUDA source's own sizes)
ALL_FIT = Smem(split=lambda *a: 0, tile=lambda *a: 0, mla=lambda *a: 0,
               limit=232448)


def _mk(seed, B=2, S=1, H=4, K=2, Dk=16, Dv=16, P=12, ps=4, npps=4,
        filled=None, permute=True, q2dim=None, q_from_zero=False):
    """Random paged-attention problem with a fragmented, permuted pool
    (numpy; the same generator as the reference test's ``_mk``). Queries
    sit at the last positions past each slot's history, or with
    ``q_from_zero`` at the history's own last S positions (a prefill)."""
    r = np.random.default_rng(seed)
    k = r.standard_normal((P, ps, K, Dk), np.float32)
    v = r.standard_normal((P, ps, K, Dv), np.float32)
    order = r.permutation(P) if permute else np.arange(P)
    tables = np.full((B, npps), -1, np.int32)
    kpos = np.full((P, ps), -1, np.int32)
    filled = [npps] * B if filled is None else filled
    n = 0
    for b in range(B):
        for j in range(filled[b]):
            pg = order[n]
            n += 1
            tables[b, j] = pg
            kpos[pg] = j * ps + np.arange(ps)
    hist = np.asarray([f * ps for f in filled])
    first = hist - S if q_from_zero else hist - 1
    q_pos = (first[:, None] + np.arange(S)[None]).astype(np.int32)
    q = r.standard_normal((B, S, H, Dk), np.float32)
    q2 = k2 = None
    if q2dim:
        q2 = r.standard_normal((B, S, H, q2dim), np.float32)
        k2 = r.standard_normal((P, ps, K, q2dim), np.float32)
    return dict(q=q, k=k, v=v, kpos=kpos, tables=tables, q_pos=q_pos,
                q2=q2, k2=k2)


def _ragged():
    a = _mk(4, B=3, S=8, filled=[4, 2, 3])
    a["q_pos"][1, 5:] = -1                       # row 1: 5 real query rows
    return a


# (name, problem, keyword args) — the grid of tests/test_paged_attention.py
CASES = [
    *[(f"ps{ps}", lambda ps=ps, n=n: _mk(0, P=16, ps=ps, npps=n), {})
      for ps, n in [(2, 6), (4, 4), (8, 2)]],
    *[(f"H{H}K{K}", lambda H=H, K=K: _mk(1, H=H, K=K), {})
      for H, K in [(4, 4), (4, 2), (4, 1)]],
    ("window_softcap", lambda: _mk(2), dict(window=6, softcap=30.0)),
    ("mla_two_component", lambda: _mk(3, K=1, H=4, q2dim=8),
     dict(scale=1.0 / math.sqrt(16 + 8))),
    ("prefill_ragged_padded", _ragged, {}),
    ("partial_tables_full_pool",
     lambda: _mk(5, B=4, P=12, npps=4, filled=[4, 0, 3, 4]), {}),
    # S*G >= 64: the tile route in bf16, the general one in f32; two row
    # tiles and two key tiles, the second hidden from the first row tile
    ("prefill_tiles", lambda: _mk(8, S=32, H=8, K=2, P=40, ps=4, npps=24,
                                  filled=[20, 18], q_from_zero=True), {}),
    ("prefill_tiles_window_softcap",
     lambda: _mk(9, S=32, H=8, K=2, P=40, ps=4, npps=24, filled=[20, 18],
                 q_from_zero=True), dict(window=20, softcap=30.0)),
    # S*G >= 64 with q2/k2 (MLA's prefill): the general kernel in both types
    ("mla_prefill", lambda: _mk(10, S=32, H=4, K=1, P=40, ps=4, npps=24,
                                filled=[20, 18], q2dim=8, q_from_zero=True),
     dict(scale=1.0 / math.sqrt(16 + 8))),
]
IDS = [c[0] for c in CASES]
# where each case goes, in f32 and in bf16
ROUTE = {name: ("split", "split") for name in IDS}
ROUTE["prefill_tiles"] = ROUTE["prefill_tiles_window_softcap"] = (
    "general", "tile")
ROUTE["mla_prefill"] = ("general", "general")


def _torch_args(a, device="cpu", dtype=torch.float32):
    out = {}
    for name, x in a.items():
        if x is None:
            out[name] = None
        elif x.dtype == np.int32:
            out[name] = torch.from_numpy(x).to(device)
        else:
            out[name] = torch.from_numpy(x).to(device=device, dtype=dtype)
    return out


def _call(fn, a, **kw):
    return fn(a["q"], a["k"], a["v"], a["kpos"], a["tables"], a["q_pos"],
              q2=a["q2"], k2=a["k2"], **kw)


@pytest.fixture(scope="module")
def jax_paged():
    """The reference kernel (interpret mode) and oracle, imported here so
    the module itself imports without JAX."""
    import jax.numpy as jnp
    from repro.kernels.paged_attention import paged_attention as jpa
    from repro.kernels.ref import paged_attention_ref as jref

    def run(a, **kw):
        j = {k: (jnp.asarray(x) if x is not None else None)
             for k, x in a.items()}
        kern = _call(jpa, j, interpret=True, block_q=8, **kw)
        ref = _call(jref, j, **kw)
        return np.asarray(kern), np.asarray(ref)

    return run


@pytest.mark.parametrize("name,make,kw", CASES, ids=IDS)
def test_plain_matches_reference_kernel_and_oracle(jax_paged, name, make, kw):
    a = make()
    j_kern, j_ref = jax_paged(a, **kw)
    launches = paged_attention.launches
    out = _call(paged_attention, _torch_args(a), **kw).numpy()
    assert paged_attention.launches == launches    # the CPU never launches
    np.testing.assert_allclose(out, j_kern, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out, j_ref, atol=ATOL, rtol=RTOL)
    if name == "prefill_ragged_padded":
        assert np.all(out[1, 5:] == 0.0)          # pad query rows -> zeros
    if name == "partial_tables_full_pool":
        assert np.all(out[1] == 0.0)              # dead slot -> zeros


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a = _torch_args(_mk(0))
    with pytest.raises(TypeError):                # mixed float dtypes
        paged_attention(a["q"].double(), a["k"], a["v"], a["kpos"],
                        a["tables"], a["q_pos"])
    with pytest.raises(TypeError):                # int64 table
        paged_attention(a["q"], a["k"], a["v"], a["kpos"],
                        a["tables"].long(), a["q_pos"])
    with pytest.raises(ValueError):               # non-contiguous q
        paged_attention(a["q"].transpose(1, 2), a["k"], a["v"], a["kpos"],
                        a["tables"], a["q_pos"])
    with pytest.raises(ValueError):               # H % K != 0
        paged_attention(a["q"][:, :, :3].contiguous(), a["k"], a["v"],
                        a["kpos"], a["tables"], a["q_pos"])
    with pytest.raises(ValueError):               # q2 without k2
        paged_attention(a["q"], a["k"], a["v"], a["kpos"], a["tables"],
                        a["q_pos"], q2=a["q"])


# ---------------------------------------------------------------------------
# What the kernels compute, emulated on the CPU
# ---------------------------------------------------------------------------

def _visible(kp, q_pos, causal, window):
    """(B, S, keys) bool: the keys each query row sees (kp: (B, keys))."""
    vis = (kp >= 0)[:, None, :]
    if causal:
        vis = vis & (kp[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        vis = vis & ((q_pos[:, :, None] - kp[:, None, :]) < window)
    return vis


def _emulate_split(a, splits, *, scale=None, causal=True, window=None,
                   softcap=None):
    """The split route in plain PyTorch, f32: each of ``splits`` ranges of
    ceil(npps / splits) table entries gives a partial (m, l, acc) by the
    page-by-page online softmax (p re-masked after the exp); the combine
    rescales each partial with l > 0 by exp(m_i - m) and divides by the
    summed l. A range may hold only dead entries: its l is 0."""
    q, k, v, kpos, tables, q_pos = (a[n].float() if a[n].is_floating_point()
                                    else a[n] for n in ("q", "k", "v", "kpos",
                                                        "tables", "q_pos"))
    B, S, H, Dk = q.shape
    P, ps, K, _ = k.shape
    G, npps, Dv = H // K, tables.shape[1], v.shape[-1]
    q2 = a["q2"].float() if a["q2"] is not None else None
    if scale is None:
        scale = 1.0 / math.sqrt(Dk + (q2.shape[-1] if q2 is not None else 0))
    qg = q.reshape(B, S, K, G, Dk)
    per = -(-npps // splits)
    parts = []
    for sp in range(splits):
        m = torch.full((B, S, K, G), -1e30)
        l = torch.zeros((B, S, K, G))
        acc = torch.zeros((B, S, K, G, Dv))
        for j in range(sp * per, min((sp + 1) * per, npps)):
            t = tables[:, j]
            tc = t.clamp(min=0).long()
            kp = torch.where((t >= 0)[:, None], kpos[tc], -1)
            s = torch.einsum("bskgd,bpkd->bskgp", qg, k[tc])
            if q2 is not None:
                s = s + torch.einsum("bskgd,bpkd->bskgp",
                                     q2.reshape(B, S, K, G, -1),
                                     a["k2"].float()[tc])
            s = s * scale
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            vis = _visible(kp, q_pos, causal, window)[:, :, None, None, :]
            s = torch.where(vis, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(vis, torch.exp(s - m_new[..., None]), 0.0)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bskgp,bpkd->bskgd", p, v[tc])
            m = m_new
        parts.append((m, l, acc))
    M, L, A = (torch.stack(x) for x in zip(*parts))
    live = L > 0
    mx = torch.where(live, M, -math.inf).amax(0)
    w = torch.where(live, torch.exp(M - mx), 0.0)
    l = (w * L).sum(0)
    acc = (w[..., None] * torch.where(live[..., None], A, 0.0)).sum(0)
    out = acc / torch.where(l > 0, l, 1.0)[..., None]
    return out.reshape(B, S, H, Dv)


def _emulate_tile(a, *, split=True, bk=64, scale=None, causal=True,
                  window=None, softcap=None):
    """The tile route's rounding points in plain PyTorch: the slot's key
    rows in table order (key r in entry r // ps, row r % ps; a dead entry's
    rows zero and masked), bf16 q.k summed in f32, scale, softcap and mask
    in f32, an online softmax over ``bk``-key tiles with m, l and acc in
    f32, l summed from the f32 p, p @ v as P_hi @ v + P_lo @ v with P_hi =
    bf16(p), P_lo = bf16(p - P_hi) (``split``; else bf16(p) @ v alone), the
    output rounded to bf16 once."""
    q, k, v, kpos, tables, q_pos = (a[n] for n in ("q", "k", "v", "kpos",
                                                   "tables", "q_pos"))
    B, S, H, Dk = q.shape
    P, ps, K, _ = k.shape
    G, npps, Dv = H // K, tables.shape[1], v.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(Dk)
    cl = tables.clamp(min=0).long()
    live = (tables >= 0).repeat_interleave(ps, dim=1)            # (B, keys)
    kd = torch.where(live[..., None, None],
                     k[cl].reshape(B, npps * ps, K, Dk).float(), 0.0)
    vd = torch.where(live[..., None, None],
                     v[cl].reshape(B, npps * ps, K, Dv).float(), 0.0)
    kp = torch.where(live, kpos[cl].reshape(B, -1), -1)
    qg = q.float().reshape(B, S, K, G, Dk)
    m = torch.full((B, S, K, G, 1), -1e30)
    l = torch.zeros((B, S, K, G, 1))
    acc = torch.zeros((B, S, K, G, Dv))
    for k0 in range(0, npps * ps, bk):
        kt, vt = kd[:, k0:k0 + bk], vd[:, k0:k0 + bk]
        s = torch.einsum("bskgd,bpkd->bskgp", qg, kt) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        vis = _visible(kp[:, k0:k0 + bk], q_pos, causal,
                       window)[:, :, None, None, :]
        s = torch.where(vis, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(vis, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        pv = torch.einsum("bskgp,bpkd->bskgd", hi, vt)
        if split:
            pv = pv + torch.einsum("bskgp,bpkd->bskgd",
                                   (p - hi).to(torch.bfloat16).float(), vt)
        acc = acc * alpha + pv
        m = m_new
    out = acc / torch.where(l > 0, l, 1.0)
    return out.reshape(B, S, H, Dv).to(torch.bfloat16)


def _f32_answer(a, **kw):
    """The exact answer for these inputs: the oracle in f32."""
    f = {n: (x.float() if x is not None and x.is_floating_point() else x)
         for n, x in a.items()}
    return _call(paged_attention_ref, f, **kw)


@pytest.mark.parametrize("name,make,kw", CASES, ids=IDS)
def test_split_emulation_matches_oracle_for_every_split_count(name, make,
                                                              kw):
    """Partials over any ranges of table entries (ranges of only dead
    entries included) combine to the oracle's answer within f32 2e-5; an
    all-dead slot and pad query rows come out as exact zeros."""
    a = _torch_args(make())
    ref = _call(paged_attention_ref, a, **kw)
    npps = a["tables"].shape[1]
    for splits in range(1, npps + 1):
        out = _emulate_split(a, splits, **kw)
        torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL,
                                   msg=lambda m: f"{splits} splits: {m}")
        if name == "prefill_ragged_padded":
            assert bool((out[1, 5:] == 0).all())
        if name == "partial_tables_full_pool":
            assert bool((out[1] == 0).all())


# narrow prefill shapes for the tile route: G = 5 as qwen3-14b, 16-row pages
TILE_SHAPES = [
    ("prefill_g5", dict(B=2, S=128, H=10, K=2, Dk=32, Dv=32, P=24, ps=16,
                        npps=12, filled=[8, 10], q_from_zero=True), {}),
    ("prefill_g5_window_softcap",
     dict(B=2, S=128, H=10, K=2, Dk=32, Dv=32, P=24, ps=16, npps=12,
          filled=[8, 10], q_from_zero=True), dict(window=100, softcap=30.0)),
    ("prefill_long_keys", dict(B=1, S=64, H=4, K=4, Dk=64, Dv=64, P=40,
                               ps=16, npps=40, filled=[40],
                               q_from_zero=True), {}),
    # stablelm-12b's head dim: 2.5 boxes of 64 columns
    ("prefill_d160", dict(B=2, S=32, H=8, K=2, Dk=160, Dv=160, P=24, ps=16,
                          npps=12, filled=[6, 12], q_from_zero=True), {}),
]


@pytest.mark.parametrize("name,shape,kw", TILE_SHAPES,
                         ids=[c[0] for c in TILE_SHAPES])
def test_tile_emulation_within_one_bf16_rounding(name, shape, kw):
    """The tile route's rounding design keeps the bf16 output within one
    bf16 rounding of the f32 answer for the same bf16 inputs."""
    a = _torch_args(_mk(11, **shape), dtype=torch.bfloat16)
    assert _route(a["q"], a["k"], a["v"], None, a["tables"], N_SM,
                  ALL_FIT) == "tile"
    out = _emulate_tile(a, **kw)
    torch.testing.assert_close(out.float(), _f32_answer(a, **kw),
                               **ONE_ROUNDING)


def test_tile_emulation_single_bf16_p_fails_one_rounding():
    """The control, and why P is split: p rounded once to bf16 before
    p @ v does not hold that limit where a row sees 640 keys."""
    name, shape, kw = TILE_SHAPES[2]
    a = _torch_args(_mk(11, **shape), dtype=torch.bfloat16)
    exact = _f32_answer(a, **kw)
    single = _emulate_tile(a, split=False, **kw).float()
    assert int((~torch.isclose(single, exact, **ONE_ROUNDING)).sum()) > 0


def _shapes_only(a):
    """Tensors of ``a``'s shapes and dtypes whose contents say nothing:
    tables all dead, positions all -1, floats uninitialized."""
    return {n: (None if x is None else
                torch.full_like(x, -1) if not x.is_floating_point() else
                torch.empty_like(x)) for n, x in a.items()}


@pytest.mark.parametrize("name,make,kw", CASES, ids=IDS)
def test_route_goes_by_shapes_alone(name, make, kw):
    for dtype, want in zip((torch.float32, torch.bfloat16), ROUTE[name]):
        a = _torch_args(make(), dtype=dtype)
        got = [_route(x["q"], x["k"], x["v"], x["q2"], x["tables"], N_SM,
                      ALL_FIT) for x in (a, _shapes_only(a))]
        assert got == [want, want], (dtype, got)


def test_route_at_the_serving_shapes():
    """qwen3-14b's (H 40, K 8, D 128, 16-row pages, 32 table entries):
    decode splits, a prefill of 128 tokens takes tiles, f32 prefill the
    general kernel, odd pages and D > 256 too; a bf16 prefill with q2/k2
    and v the tensor k is MLA's absorbed form: the mla route."""
    def route(S, dtype=torch.bfloat16, D=128, ps=16, q2=None):
        q = torch.empty((4, S, 40, D), dtype=dtype)
        k = torch.empty((128, ps, 8, D), dtype=dtype)
        return _route(q, k, k, q2, torch.empty((4, 32), dtype=torch.int32),
                      N_SM, ALL_FIT)
    assert route(1) == "split" and route(1, torch.float32) == "split"
    assert route(12) == "split"                  # 60 rows: a short prefill
    assert route(13) == route(128) == "tile"
    assert route(128, torch.float32) == "general"
    assert route(128, q2=torch.empty((4, 128, 40, 64),
                                     dtype=torch.bfloat16)) == "mla"
    assert route(128, ps=12) == "general" and route(128, D=288) == "general"
    assert route(1, D=4) == "general"            # 8 bytes a bf16 row


@pytest.mark.parametrize("B,K,npps", [(4, 8, 32), (4, 8, 256), (1, 1, 1),
                                      (1, 8, 32), (8, 8, 529), (3, 2, 7),
                                      (64, 8, 32)])
def test_splits_cover_the_table(B, K, npps):
    """Every split range is non-empty and together they cover the table;
    the decode shapes get 16 splits: 512 blocks on 132 SMs."""
    splits = _splits(B, K, npps, N_SM)
    per = -(-npps // splits)
    assert 1 <= splits <= npps
    assert (splits - 1) * per < npps <= splits * per
    if (B, K) == (4, 8):
        assert splits == 16


def test_route_takes_general_where_a_block_does_not_fit():
    """A split, tile or mla block that would not fit in shared memory
    sends the call to the general kernel; the sizes asked for are the
    block's."""
    asked = []

    def size(route, n):
        def f(*args):
            asked.append((route, args))
            return n
        return f

    q = torch.empty((4, 1, 40, 128), dtype=torch.bfloat16)
    k = torch.empty((128, 16, 8, 128), dtype=torch.bfloat16)
    qp = torch.empty((4, 128, 40, 128), dtype=torch.bfloat16)
    tab = torch.empty((4, 32), dtype=torch.int32)
    # deepseek-v2's absorbed prefill: 128 heads over one latent head of
    # 512 + 64 columns, v the tensor k
    mq = torch.empty((4, 128, 128, 512), dtype=torch.bfloat16)
    mk = torch.empty((128, 16, 1, 512), dtype=torch.bfloat16)
    mq2 = torch.empty((4, 128, 128, 64), dtype=torch.bfloat16)
    mk2 = torch.empty((128, 16, 1, 64), dtype=torch.bfloat16)
    for n, split, tile, mla in [(100, "split", "tile", "mla"),
                                (101, "general", "general", "general")]:
        smem = Smem(size("split", n), size("tile", n), size("mla", n), 100)
        assert _route(q, k, k, None, tab, N_SM, smem) == split
        assert _route(qp, k, k, None, tab, N_SM, smem) == tile
        assert _route(mq, mk, mk, mq2, tab, N_SM, smem) == mla
    # G = 5 rows, 16-row pages, 128 + 128 columns, 2 bytes, 2 entries a
    # range; the mla block: Dk 512, 32 entries of 16 rows
    assert asked == [("split", (5, 16, 128, 128, 2, 2)),
                     ("tile", (128, 128, 32, 16)),
                     ("mla", (512, 32, 16))] * 2


def test_library_smem_serves_the_plan_cache(monkeypatch):
    """The library's shared-memory functions (ctypes functions, which do not
    hash) reach ``_route`` through ``_plan``'s cache; libc's ``labs`` and
    ``getpid`` stand in for them here."""
    import ctypes
    from repro_torch.kernels import paged_attention as pa
    libc = ctypes.CDLL(None)

    class Lib:
        paged_attention_split_smem_bytes = libc.labs
        paged_attention_tile_smem_bytes = libc.labs
        paged_attention_mla_smem_bytes = libc.labs
        paged_attention_max_smem_bytes = libc.getpid

    monkeypatch.setattr(pa._build, "load", lambda name: Lib)
    pa._library_smem.cache_clear()
    try:
        smem = pa._library_smem()
        q = torch.empty((4, 1, 40, 128), dtype=torch.bfloat16)
        k = torch.empty((128, 16, 8, 128), dtype=torch.bfloat16)
        tab = torch.empty((4, 32), dtype=torch.int32)
        assert _route(q, k, k, None, tab, N_SM, smem) == "split"
        assert _route(q, k, k, None, tab, N_SM, smem) == "split"
    finally:
        pa._library_smem.cache_clear()


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 2e-5),
                                             (torch.bfloat16, 2e-2, 1e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name,make,kw", CASES, ids=IDS)
def test_cuda_kernel_matches_plain(cuda_device, dtype, atol, rtol, name,
                                   make, kw):
    a = _torch_args(make(), cuda_device, dtype)
    launches = paged_attention.launches
    routes = dict(paged_attention.routes)
    out = _call(paged_attention, a, **kw)
    torch.cuda.synchronize()
    assert paged_attention.launches == launches + 1
    route = ROUTE[name][dtype == torch.bfloat16]
    assert paged_attention.routes == {**routes, route: routes[route] + 1}
    ref = _call(paged_attention_ref, a, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)
    if name == "prefill_ragged_padded":
        assert bool((out[1, 5:] == 0).all())
    if name == "partial_tables_full_pool":
        assert bool((out[1] == 0).all())


def _serving(kind, device):
    """qwen3-14b's attention at the serving path's shapes, bf16: 4 slots,
    40 / 8 heads of 128, 16-row pages, 32 table entries; decode over 9 live
    entries, prefill of 128 tokens over 8."""
    S, filled = (1, 9) if kind == "decode" else (128, 8)
    a = _mk(12, B=4, S=S, H=40, K=8, Dk=128, Dv=128, P=128, ps=16, npps=32,
            filled=[filled] * 4, q_from_zero=kind == "prefill")
    return _torch_args(a, device, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,route", [("decode", "split"),
                                        ("prefill", "tile")])
def test_cuda_serving_shapes_within_one_rounding(cuda_device, kind, route):
    a = _serving(kind, cuda_device)
    routes = dict(paged_attention.routes)
    out = _call(paged_attention, a)
    torch.cuda.synchronize()
    assert paged_attention.routes[route] == routes[route] + 1
    ref = _call(paged_attention_ref, a)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=1e-2)
    torch.testing.assert_close(out.float(), _f32_answer(a), **ONE_ROUNDING)


@pytest.mark.cuda
def test_cuda_tile_route_within_one_rounding_on_narrow_shapes(cuda_device):
    for name, shape, kw in TILE_SHAPES:
        a = _torch_args(_mk(11, **shape), cuda_device, torch.bfloat16)
        out = _call(paged_attention, a, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), _f32_answer(a, **kw),
                                   **ONE_ROUNDING,
                                   msg=lambda m: f"{name}: {m}")


# the other shapes the split and tile routes take: several 16-row mma tiles
# (S*G = 60), and the tile route at every box count of the head dims, with
# 32-key tiles (Dv > 128), pages longer than a tile, pages of 8 rows and a
# last key tile only partly in the table
ROUTE_SHAPES = [
    ("split_60_rows", dict(B=2, S=12, H=10, K=2, Dk=128, Dv=128, P=24, ps=16,
                           npps=12, filled=[8, 11], q_from_zero=True),
     "split"),
    ("tile_d256_ps64", dict(B=2, S=64, H=4, K=2, Dk=256, Dv=256, P=12, ps=64,
                            npps=5, filled=[3, 5], q_from_zero=True), "tile"),
    ("tile_d256_ps16", dict(B=1, S=64, H=4, K=2, Dk=256, Dv=256, P=24, ps=16,
                            npps=11, filled=[11], q_from_zero=True), "tile"),
    ("tile_d192_dv128", dict(B=1, S=64, H=4, K=2, Dk=192, Dv=128, P=24,
                             ps=32, npps=7, filled=[5], q_from_zero=True),
     "tile"),
    ("tile_d112_ps8", dict(B=2, S=48, H=8, K=2, Dk=112, Dv=112, P=40, ps=8,
                           npps=19, filled=[9, 19], q_from_zero=True),
     "tile"),
    # stablelm-12b's D = 160 (2.5 boxes) on both routes, and olmoe's G = 1
    ("tile_d160", dict(B=2, S=64, H=8, K=2, Dk=160, Dv=160, P=24, ps=16,
                       npps=12, filled=[6, 12], q_from_zero=True), "tile"),
    ("split_d160", dict(B=4, S=1, H=32, K=8, Dk=160, Dv=160, P=40, ps=16,
                        npps=10, filled=[9, 10, 3, 7]), "split"),
    ("tile_g1", dict(B=2, S=64, H=4, K=4, Dk=128, Dv=128, P=24, ps=16,
                     npps=12, filled=[5, 12], q_from_zero=True), "tile"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,route", ROUTE_SHAPES,
                         ids=[c[0] for c in ROUTE_SHAPES])
def test_cuda_route_shapes_within_one_rounding(cuda_device, name, shape,
                                               route):
    a = _torch_args(_mk(13, **shape), cuda_device, torch.bfloat16)
    routes = dict(paged_attention.routes)
    out = _call(paged_attention, a)
    torch.cuda.synchronize()
    assert paged_attention.routes[route] == routes[route] + 1
    torch.testing.assert_close(out.float(), _f32_answer(a), **ONE_ROUNDING)


@pytest.mark.cuda
def test_cuda_routes_fit_at_the_serving_shapes(cuda_device):
    """With the CUDA source's own shared-memory sizes, qwen3-14b's decode
    splits (a block under 48 KB) and its prefill takes tiles (two blocks an
    SM)."""
    smem = _library_smem()
    assert smem.limit == 232448
    assert smem.split(5, 16, 128, 128, 2, 2) < 48 * 1024
    assert smem.tile(128, 128, 32, 16) <= smem.limit // 2
    for kind, route in (("decode", "split"), ("prefill", "tile")):
        a = _serving(kind, cuda_device)
        assert _route(a["q"], a["k"], a["v"], None, a["tables"], N_SM,
                      smem) == route


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,make,kw", CASES, ids=IDS)
def test_meta_call_takes_the_plain_version(name, make, kw, dtype):
    """On ``meta`` tensors (the dry run's) the wrapper returns the plain
    version's shape and dtype and launches nothing."""
    a = _torch_args(make(), dtype=dtype)
    want = _call(paged_attention_ref, a, **kw)
    meta = {k: (x.to("meta") if x is not None else None)
            for k, x in a.items()}
    launches, routes = paged_attention.launches, dict(paged_attention.routes)
    out = _call(paged_attention, meta, **kw)
    assert out.device.type == "meta"
    assert out.shape == want.shape and out.dtype == want.dtype == dtype
    assert paged_attention.launches == launches
    assert paged_attention.routes == routes
