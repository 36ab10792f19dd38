// Paged attention for Hopper (sm_90a): attention over pool-resident KV with
// the page-table walk inside the kernel.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::_kernel
// (called through paged_attention). Same function: each slot's page list
// tables[b, :] is walked in order, dead pages (-1) are skipped, empty rows
// (kpos -1) are masked, causal / sliding-window / softcap come from kpos and
// q_pos, an optional second score term q2.k2 serves MLA's absorbed form, and
// a pad query row or an all-dead slot comes out as exact zeros.
//
// Four routes, chosen by the wrapper from shapes alone (never from the
// contents of tables, kpos or q_pos, so a call stays capturable in a CUDA
// graph). A block's rows are (query i, group g) pairs of one (slot b, kv head
// kh), flattened as i*G + g, so the G query heads of a kv head share every
// staged page.
//
// split (S*G < 64: decode and short prefills; f32 or bf16; q2/k2 too).
//   What bounds it: bytes and latency. At G = 5 rows a kv head decode does
//   2 flops per byte of K/V, and 4 slots x 8 kv heads are only 32 blocks on
//   132 SMs if each walks its table alone. So the table is split: one
//   128-thread block per (split, kv head, slot) takes a contiguous range of
//   table entries (flash-decoding), enough splits for ~4 blocks an SM (16
//   at qwen3-14b's decode: 512 blocks). Live pages stream through a 3-stage
//   ring of 16-byte cp.async copies, so pages j+1 and j+2 load while page
//   j's math runs. Scores: in bf16, one warp per (16-row, 8-key) tile runs
//   mma.sync m16n8k16 over q and k rows padded by 8 columns (each bf16
//   product is exact, the sums f32); in f32, lane groups on the CUDA cores
//   split D in 16-byte vectors and reduce with shuffles. The online softmax
//   runs a row on a group of lanes, p @ V one thread per (row, 16 bytes of
//   columns), in f32 on the CUDA cores. Each split writes (m, l, acc) in f32
//   to a workspace; paged_combine_kernel rescales each by exp(m_i - m), sums
//   and divides by l. The output is rounded once.
//
// tile (S*G >= 64, bf16, no q2, Dk and Dv multiples of 8 up to 256, ps a
//   divisor of 64: prefill). What bounds it: at prefill 64 (query, group)
//   rows share every key, so the work is flash attention's inner loop, and
//   the tensor cores take both products: flash_attention.cu's bf16
//   design over a key tile gathered from pages. One
//   160-thread block per (64-row tile, kv head, slot): a producer warp
//   assembles each 64-key (32 where Dv > 128) k and v tile from the slot's
//   pages into 2-stage rings with mbarriers, in the 128-byte-swizzled layout
//   that wgmma reads: by TMA, one box per page piece and 64 columns, where
//   pages hold 8 rows or more (a piece then starts a swizzle atom), else by
//   16-byte cp.async; q by cp.async. One consumer warpgroup runs S = q k^T
//   and acc += P_hi V + P_lo V by wgmma (P split in two bf16 terms, so the
//   output keeps one bf16 rounding), the online softmax on the fragment in
//   registers. Before the loop the block marks each table entry live or
//   not: dead, all rows empty, after the tile's last query position
//   (causal) or out of the window of its first one. A key tile with no live
//   entry is never loaded; a dead entry's rows are never loaded and are
//   masked (the v ring starts at zeros, so p = 0 never meets a NaN).
//
// mla (S*G >= 64, bf16, q2/k2 present, v the same tensor as k, Dk a
//   multiple of 64 up to 512, Dk2 a multiple of 8 up to 64, pages of a
//   power of two >= 8 rows: deepseek-v2's absorbed form, H 128 over one
//   latent head, [q_abs | q_rope] . [ckv | kr] with Dk 512 + Dk2 64 and
//   values the same ckv). What bounds it: every key is 1,152 bytes shared
//   by 128 query heads, so a 64-row block does ~100 flops a staged byte
//   (S and P_hi/P_lo @ V on wgmma): the tensor cores at long decode, the
//   bytes of q and the output at prefill. One 384-thread block per (64-row
//   tile, split, slot x kv head): three warpgroups, registers moved from
//   the producer warpgroup to the consumers by setmaxnreg (40 and 232 a
//   thread; an SM allots registers to warps in fours, so 288 threads would
//   cap them at 168 and spill). One producer warp assembles 32-key tiles of
//   [ckv | kr] (8 + 1 boxes of 64 columns, 128-byte swizzled) from the
//   slot's pages by TMA, one box a page piece, into a 3-stage ring with
//   mbarriers; [q | q2] (64 x 576, 73,728 B) lands once, by TMA where the
//   64 rows are 64 heads of one query (G a multiple of 64: deepseek-v2's
//   128), else by the consumers' cp.async. The staged ckv boxes are both
//   the K operand of S = [q|q2] [ckv|kr]^T (K-major, 36 k16 steps) and the
//   V operand of P @ V (MN-major, the transpose bit): V is never staged on
//   its own (the design of DeepSeek's public FlashMLA for this card). Two
//   consumer warpgroups each own half of the value columns (64 x 256 f32,
//   128 registers a thread; one m64n256k16 a k16 step and term). Warpgroup
//   0 computes S and the online softmax (keys_softmax, the tile route's
//   masks, the keys' kpos and table entries read before the products are
//   issued) and hands P, split in two bf16 terms (the output keeps one
//   bf16 rounding), and the row rescale alpha to warpgroup 1 through two
//   shared-memory buffers (64 * BK * 4 bytes and an mbarrier pair each)
//   rather than both computing S: that would repeat its 576-deep product
//   (36% more tensor-core work a tile), where the hand-off costs 18 KB and
//   lets warpgroup 0 run S(i + 1) while warpgroup 1 runs P(i) @ V. Shared
//   memory at Dk 512: 1,024 (alignment) + q 73,728 + 3 stages x 32 keys x
//   1,152 = 110,592 + P buffers 18,432 + l 1,024 + kpos 384 + barriers 112
//   + the table and live-tile list (~206 KB at 256 entries of 16 rows, one
//   block an SM; 32-key tiles with 3 stages: 64 keys with 2 stages would
//   need 237,568 bytes). Before the loop the block marks the entries of its
//   range live or dead (dead, empty, after its last query position, out of
//   the window; a warp an entry); a tile with no live entry is never
//   loaded, a dead entry's rows are masked and its ring rows start at
//   zeros. At decode (S = 1: 2 row tiles a slot) each slot's table is cut
//   into ranges of whole key tiles, enough for about one block an SM; each
//   writes (m, l, acc) in f32 to the split route's workspace and
//   paged_combine_kernel joins them, so the output is rounded once. A
//   prefill (many row tiles) runs unsplit. A block's 64 output rows (bf16,
//   or a split's f32 partial) are staged in shared memory and written out
//   whole, 16 bytes a lane. Left for later (a tile takes ~3,200 cycles
//   against ~1,600 of tensor-core work): S is 36 m64n32k16 products that
//   re-read the q tile every 32 keys; warpgroup 0's softmax and hand-off
//   leave the tensor cores idle between S(i + 1) and S(i + 2) (a second S
//   accumulator would overlap them); a decode's split partials (R x 512
//   f32 each) and their combine cost more than its keys.
//
// general (everything else: f32 prefill, Dk > 256 without the mla route's
//   shape, odd page sizes): the first design, below. One block per (row
//   chunk, kv head, slot) walks the table in order; per live page it stages
//   K (and K2), V and kpos in f32, one thread per (row, key) computes the
//   score, one thread per row the online-softmax update (p re-masked after
//   the exp: an all-masked prefix leaves m_new = -1e30 and exp(s - m_new) =
//   1), one thread per (row, output column) acc = acc*alpha + p.V; the
//   output is acc / (l > 0 ? l : 1).
//
// Left for later: a split grid sized by live pages rather than table
// entries (only the wrapper could count them, with a sync); one split block
// serving all kv heads of a slot (whole pool rows, fewer blocks); p @ V on
// the tensor cores in the split route; fp8 pages.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 128;
constexpr int kMaxRows = 64;              // (query, group) rows per block
constexpr size_t kMaxSmem = 232448;       // 227 KB: a block's opt-in limit
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;       // (B, S, H, Dk)
  const void* k;       // (P, ps, K, Dk)
  const void* v;       // (P, ps, K, Dv)
  const int* kpos;     // (P, ps)
  const int* tables;   // (B, npps)
  const int* q_pos;    // (B, S)
  const void* q2;      // (B, S, H, Dk2) or null
  const void* k2;      // (P, ps, K, Dk2) or null
  void* out;           // (B, S, H, Dv)
  int B, S, H, K, Dk, Dk2, Dv, P, ps, npps, rows;
  float scale;
  int causal, has_window, window, has_cap;
  float cap;
  float inv_cap;       // 1 / cap, from the host (the split route)
};

__device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, size_t i, float x) { p[i] = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, float x) {
  p[i] = __float2bfloat16(x);
}

__device__ __forceinline__ bool visible(int kp, int qp, const Params& p) {
  bool ok = kp >= 0;
  if (p.causal) ok = ok && kp <= qp;
  if (p.has_window) ok = ok && (qp - kp) < p.window;
  return ok;
}

// Shared-memory footprint in floats (the two int arrays count as floats).
// Q and K rows get one float of padding so that threads reading different
// key rows at the same column hit different banks.
__host__ __device__ inline size_t smem_floats(int rows, int ps, int Dk,
                                              int Dk2, int Dv) {
  const size_t dkp = Dk + 1, dk2p = Dk2 ? Dk2 + 1 : 0;
  const size_t per_row = dkp + dk2p + Dv + ps + 4;   // q, q2, acc, p, m l a qp
  const size_t per_key = dkp + dk2p + Dv + 1;        // k, k2, v, kpos
  return rows * per_row + ps * per_key;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const __grid_constant__ Params p) {
  const int b = blockIdx.z, kh = blockIdx.y;
  const int G = p.H / p.K;
  const int r0 = blockIdx.x * p.rows;
  const int R = min(p.rows, p.S * G - r0);
  const int tid = threadIdx.x;
  const int ps = p.ps, Dk = p.Dk, Dk2 = p.Dk2, Dv = p.Dv;
  const int dkp = Dk + 1, dk2p = Dk2 ? Dk2 + 1 : 0;

  extern __shared__ float smem[];
  float* sQ = smem;                          // rows x dkp
  float* sQ2 = sQ + p.rows * dkp;            // rows x dk2p
  float* sAcc = sQ2 + p.rows * dk2p;         // rows x Dv
  float* sP = sAcc + p.rows * Dv;            // rows x ps: scores, then p
  float* sM = sP + p.rows * ps;              // rows: running max
  float* sL = sM + p.rows;                   // rows: running sum
  float* sAlpha = sL + p.rows;               // rows: this page's rescale
  int* sQP = reinterpret_cast<int*>(sAlpha + p.rows);   // rows: q_pos
  float* sK = reinterpret_cast<float*>(sQP + p.rows);   // ps x dkp
  float* sK2 = sK + ps * dkp;                // ps x dk2p
  float* sV = sK2 + ps * dk2p;               // ps x Dv
  int* sKP = reinterpret_cast<int*>(sV + ps * Dv);      // ps: kpos

  const T* q = static_cast<const T*>(p.q);
  const T* q2 = static_cast<const T*>(p.q2);
  const T* k = static_cast<const T*>(p.k);
  const T* k2 = static_cast<const T*>(p.k2);
  const T* v = static_cast<const T*>(p.v);

  // row rr of this block -> query i = row / G, head h = kh*G + row % G
  for (int idx = tid; idx < R * Dk; idx += kThreads) {
    const int rr = idx / Dk, d = idx % Dk, row = r0 + rr;
    const size_t qi = (size_t)(b * p.S + row / G) * p.H + kh * G + row % G;
    sQ[rr * dkp + d] = load(q, qi * Dk + d);
  }
  for (int idx = tid; idx < R * Dk2; idx += kThreads) {
    const int rr = idx / Dk2, d = idx % Dk2, row = r0 + rr;
    const size_t qi = (size_t)(b * p.S + row / G) * p.H + kh * G + row % G;
    sQ2[rr * dk2p + d] = load(q2, qi * Dk2 + d);
  }
  for (int rr = tid; rr < R; rr += kThreads) {
    sQP[rr] = p.q_pos[b * p.S + (r0 + rr) / G];
    sM[rr] = kNegInf;
    sL[rr] = 0.f;
  }
  for (int idx = tid; idx < R * Dv; idx += kThreads) sAcc[idx] = 0.f;
  __syncthreads();

  for (int j = 0; j < p.npps; ++j) {
    const int t = p.tables[b * p.npps + j];   // the same for every thread
    if (t < 0 || t >= p.P) continue;          // dead page: nothing to attend
    const size_t page = (size_t)t * ps;

    // 1. stage the page (rows of kv head kh only)
    for (int idx = tid; idx < ps * Dk; idx += kThreads) {
      const int jj = idx / Dk, d = idx % Dk;
      sK[jj * dkp + d] = load(k, ((page + jj) * p.K + kh) * Dk + d);
    }
    for (int idx = tid; idx < ps * Dk2; idx += kThreads) {
      const int jj = idx / Dk2, d = idx % Dk2;
      sK2[jj * dk2p + d] = load(k2, ((page + jj) * p.K + kh) * Dk2 + d);
    }
    for (int idx = tid; idx < ps * Dv; idx += kThreads) {
      const int jj = idx / Dv, d = idx % Dv;
      sV[jj * Dv + d] = load(v, ((page + jj) * p.K + kh) * Dv + d);
    }
    for (int jj = tid; jj < ps; jj += kThreads) sKP[jj] = p.kpos[page + jj];
    __syncthreads();

    // 2. scores: f32 dot, then scale, then softcap, then mask
    for (int idx = tid; idx < R * ps; idx += kThreads) {
      const int rr = idx / ps, jj = idx % ps;
      const float* qa = sQ + rr * dkp;
      const float* ka = sK + jj * dkp;
      float s = 0.f;
      for (int d = 0; d < Dk; ++d) s = fmaf(qa[d], ka[d], s);
      if (Dk2) {
        const float* q2a = sQ2 + rr * dk2p;
        const float* k2a = sK2 + jj * dk2p;
        float s2 = 0.f;
        for (int d = 0; d < Dk2; ++d) s2 = fmaf(q2a[d], k2a[d], s2);
        s += s2;
      }
      s *= p.scale;
      if (p.has_cap) s = p.cap * tanhf(s / p.cap);
      sP[idx] = visible(sKP[jj], sQP[rr], p) ? s : kNegInf;
    }
    __syncthreads();

    // 3. online softmax, one thread per row
    for (int rr = tid; rr < R; rr += kThreads) {
      float* pr = sP + rr * ps;
      float mx = kNegInf;
      for (int jj = 0; jj < ps; ++jj) mx = fmaxf(mx, pr[jj]);
      const float m_prev = sM[rr];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int jj = 0; jj < ps; ++jj) {
        const float e =
            visible(sKP[jj], sQP[rr], p) ? expf(pr[jj] - m_new) : 0.f;
        pr[jj] = e;
        sum += e;
      }
      sL[rr] = sL[rr] * alpha + sum;
      sM[rr] = m_new;
      sAlpha[rr] = alpha;
    }
    __syncthreads();

    // 4. acc = acc * alpha + p @ V
    for (int idx = tid; idx < R * Dv; idx += kThreads) {
      const int rr = idx / Dv, d = idx % Dv;
      const float* pr = sP + rr * ps;
      float a = sAcc[idx] * sAlpha[rr];
      for (int jj = 0; jj < ps; ++jj) a = fmaf(pr[jj], sV[jj * Dv + d], a);
      sAcc[idx] = a;
    }
    __syncthreads();
  }

  // for a given query i the G heads of kv head kh are contiguous in H
  T* out = static_cast<T*>(p.out);
  for (int idx = tid; idx < R * Dv; idx += kThreads) {
    const int rr = idx / Dv, d = idx % Dv, row = r0 + rr;
    const size_t oi = (size_t)(b * p.S + row / G) * p.H + kh * G + row % G;
    const float l = sL[rr];
    store(out, oi * Dv + d, sAcc[idx] / (l > 0.f ? l : 1.f));
  }
}

template <typename T>
cudaError_t launch(const Params& p, dim3 grid, size_t smem,
                   cudaStream_t stream) {
  auto kern = paged_attention_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// split route: flash-decoding over the page table; f32 sums, bf16 q.k by
// mma.sync, the rest on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kSplitStages = 3;           // page ring: two loads in flight
constexpr int kKeep = 2;                  // 16-byte k chunks a lane keeps

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Elements a staged key row (and, in bf16, a q row) takes: bf16 rows get 8
// columns more, which spreads ldmatrix's eight row reads over all banks and
// zero-pads a last half k16 step.
__host__ __device__ inline int key_stride(int Dt, int elem) {
  return elem == 2 ? Dt + 8 : Dt;
}

// Byte offsets of a split block's shared memory: q (and q2; f32, or in bf16
// 16-row tiles of key_stride rows for mma.sync), the output accumulator,
// the scores (rows of ps rounded up to 4), four per-row arrays (m, l,
// alpha, q_pos), the block's table entries, then the ring of K (K and K2
// side by side, rows of key_stride), V and kpos pages in the input's type.
struct SplitLayout {
  size_t q, acc, s, row, tab, k, v, kp, total;
};
__host__ __device__ inline SplitLayout split_layout(int R, int ps, int Dt,
                                                    int Dv, int elem,
                                                    int per) {
  SplitLayout L;
  size_t o = 0;
  const int kst = key_stride(Dt, elem);
  L.q = o;   o += align16(elem == 2 ? (size_t)((R + 15) / 16) * 16 * kst * 2
                                    : (size_t)R * Dt * 4);
  L.acc = o; o += align16((size_t)R * Dv * 4);
  L.s = o;   o += align16((size_t)R * ((ps + 3) & ~3) * 4);
  L.row = o; o += 4 * align16((size_t)R * 4);
  L.tab = o; o += align16((size_t)per * 4);
  L.k = o;   o += (size_t)kSplitStages * ps * kst * elem;
  L.v = o;   o += (size_t)kSplitStages * ps * Dv * elem;
  L.kp = o;  o += kSplitStages * align16((size_t)ps * 4);
  L.total = o;
  return L;
}

// 16 bytes of T as floats.
__device__ __forceinline__ void to_float(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void to_float(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The copies of entry jj's page (the rows of kv head kh: K and K2 side by
// side in rows of key_stride, V, kpos) into ring stage jj % kSplitStages,
// then one commit group,
// empty for a dead entry or one past the block's range.
template <typename T>
__device__ __forceinline__ void issue_page(const Params& p, const int* sTab,
                                           int jj, int n, int kh,
                                           uint32_t k_base, uint32_t v_base,
                                           uint32_t kp_base, int kp_stride) {
  constexpr int VN = 16 / sizeof(T);
  if (jj < n && sTab[jj] >= 0) {
    const int t = sTab[jj], st = jj % kSplitStages, ps = p.ps;
    const int Dk = p.Dk, Dk2 = p.Dk2, Dt = Dk + Dk2, Dv = p.Dv;
    const int kst = key_stride(Dt, sizeof(T));
    const int ck = Dk / VN, ck2 = Dk2 / VN, cpr = ck + ck2 + Dv / VN;
    const T* const k = static_cast<const T*>(p.k);
    const T* const k2 = static_cast<const T*>(p.k2);
    const T* const v = static_cast<const T*>(p.v);
    const uint32_t kb = k_base + st * ps * kst * (int)sizeof(T);
    const uint32_t vb = v_base + st * ps * Dv * (int)sizeof(T);
    // copy idx = jr * cpr + c; (jr, c) steps by (kThreads / cpr,
    // kThreads % cpr) with a carry, so the loop divides once
    const int djr = kThreads / cpr, dc = kThreads % cpr;
    int jr = threadIdx.x / cpr, c = threadIdx.x % cpr;
    for (; jr < ps; jr += djr, c += dc) {
      if (c >= cpr) {
        c -= cpr;
        ++jr;
        if (jr >= ps) break;
      }
      const size_t row = ((size_t)t * ps + jr) * p.K + kh;
      if (c < ck)
        cp_async16(kb + (jr * kst + c * VN) * (int)sizeof(T),
                   k + row * Dk + c * VN);
      else if (c < ck + ck2)
        cp_async16(kb + (jr * kst + Dk + (c - ck) * VN) * (int)sizeof(T),
                   k2 + row * Dk2 + (c - ck) * VN);
      else
        cp_async16(vb + (jr * Dv + (c - ck - ck2) * VN) * (int)sizeof(T),
                   v + row * Dv + (c - ck - ck2) * VN);
    }
    for (int r = threadIdx.x; r < ps; r += kThreads)
      cp_async4(kp_base + (st * kp_stride + r) * 4,
                p.kpos + (size_t)t * ps + r);
  }
  cp_async_commit();
}

// bf16 tensor-core pieces of the split route's q.k: ldmatrix loads of 8x8
// bf16 tiles from shared memory and the m16n8k16 product (f32 sums).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// This split block's partial in the workspace: acc (R x Dv), then m and l
// (R each) in the second region. The block index is read afresh where it is
// used, so that no pointer stays live (and spills) across the page loop.
__device__ __forceinline__ size_t split_part() {
  uint32_t x, y, z, n;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(x));
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(y));
  asm volatile("mov.u32 %0, %%ctaid.z;" : "=r"(z));
  asm volatile("mov.u32 %0, %%nctaid.x;" : "=r"(n));
  return ((size_t)z * gridDim.y + y) * n + x;
}
__device__ __forceinline__ float* split_acc(const Params& p, float* ws) {
  return ws + split_part() * (p.S * (p.H / p.K)) * p.Dv;
}
__device__ __forceinline__ float* split_ml(const Params& p, float* ws) {
  const size_t R = p.S * (p.H / p.K);
  return ws + (size_t)p.B * p.K * gridDim.x * R * p.Dv + split_part() * 2 * R;
}

// One block per (split, kv head kh, slot b): the online softmax over the
// table entries [split * per, split * per + per), all R = S*G rows. Writes
// this split's acc (R x Dv), m and l (R each) in f32 to the workspace; a
// split without a live page writes l = 0, m = -inf.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const __grid_constant__ Params p, float* __restrict__ ws,
                   int per) {
  constexpr int VN = 16 / sizeof(T);      // elements in 16 bytes
  constexpr bool kMma = sizeof(T) == 2;   // bf16: q.k by mma.sync
  const int b = blockIdx.z, kh = blockIdx.y, sp = blockIdx.x;
  const int G = p.H / p.K, R = p.S * G;
  const int Dk = p.Dk, Dk2 = p.Dk2, Dt = Dk + Dk2, Dv = p.Dv, ps = p.ps;
  const int kst = key_stride(Dt, sizeof(T));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int j0 = sp * per, n = min(per, p.npps - j0);
  const SplitLayout L = split_layout(R, ps, Dt, Dv, sizeof(T), per);

  extern __shared__ float4 smem4[];
  unsigned char* const sm = reinterpret_cast<unsigned char*>(smem4);
  float* const sQ = reinterpret_cast<float*>(sm + L.q);
  float* const sAcc = reinterpret_cast<float*>(sm + L.acc);
  float* const sS = reinterpret_cast<float*>(sm + L.s);
  const int rs = (int)(align16((size_t)R * 4) / 4);
  float* const sM = reinterpret_cast<float*>(sm + L.row);
  float* const sL = sM + rs;
  float* const sAlpha = sL + rs;
  int* const sQP = reinterpret_cast<int*>(sAlpha + rs);
  int* const sTab = reinterpret_cast<int*>(sm + L.tab);
  const int kp_stride = (int)(align16((size_t)ps * 4) / 4);
  const int sps = (ps + 3) & ~3;            // a score row, in floats

  int any = 0;
  for (int jj = tid; jj < n; jj += kThreads) {
    int t = p.tables[b * p.npps + j0 + jj];
    t = (t >= 0 && t < p.P) ? t : -1;
    sTab[jj] = t;
    any |= t >= 0;
  }
  if (!__syncthreads_or(any)) {           // no live page: an empty partial
    float* const w_ml = split_ml(p, ws);
    for (int r = tid; r < R; r += kThreads) {
      w_ml[r] = -INFINITY;
      w_ml[R + r] = 0.f;
    }
    return;
  }

  const uint32_t k_base = smem_u32(sm + L.k), v_base = smem_u32(sm + L.v);
  const uint32_t kp_base = smem_u32(sm + L.kp);

  for (int i = 0; i < kSplitStages - 1; ++i)
    issue_page<T>(p, sTab, i, n, kh, k_base, v_base, kp_base, kp_stride);

  // q (and q2) while the first pages load, 16 bytes a thread: in f32, or
  // as bf16 in 16-row tiles (rows past R and the pad columns zero), and the
  // pad columns of the bf16 key rows zeroed once
  const T* const q = static_cast<const T*>(p.q);
  const T* const q2 = static_cast<const T*>(p.q2);
  const int ckq = Dk / VN, nck = Dt / VN;
  if constexpr (kMma) {
    const int rows = (R + 15) / 16 * 16, cq = kst / VN;
    for (int idx = tid; idx < rows * cq; idx += kThreads) {
      const int rr = idx / cq, c = idx % cq;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (rr < R && c < nck) {
        const size_t qi = (size_t)(b * p.S + rr / G) * p.H + kh * G + rr % G;
        x = *reinterpret_cast<const uint4*>(
            c < ckq ? q + qi * Dk + c * VN : q2 + qi * Dk2 + (c - ckq) * VN);
      }
      *reinterpret_cast<uint4*>(reinterpret_cast<T*>(sQ) + rr * kst +
                                c * VN) = x;
    }
    T* const sK = reinterpret_cast<T*>(sm + L.k);
    for (int r = tid; r < kSplitStages * ps; r += kThreads)
      *reinterpret_cast<uint4*>(sK + r * kst + Dt) =
          make_uint4(0u, 0u, 0u, 0u);
  } else {
    for (int idx = tid; idx < R * nck; idx += kThreads) {
      const int rr = idx / nck, c = idx % nck;
      const size_t qi = (size_t)(b * p.S + rr / G) * p.H + kh * G + rr % G;
      float x[VN];
      to_float(*reinterpret_cast<const uint4*>(
                   c < ckq ? q + qi * Dk + c * VN
                           : q2 + qi * Dk2 + (c - ckq) * VN),
               x);
#pragma unroll
      for (int e = 0; e < VN; e += 4)
        *reinterpret_cast<float4*>(sQ + rr * Dt + c * VN + e) =
            make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
    }
  }
  for (int idx = tid; idx < R * Dv; idx += kThreads) sAcc[idx] = 0.f;
  for (int rr = tid; rr < R; rr += kThreads) {
    sQP[rr] = p.q_pos[b * p.S + rr / G];
    sM[rr] = kNegInf;
    sL[rr] = 0.f;
  }

  // lane groups of LG lanes per key: the least power of two that covers a
  // key row's 16-byte chunks at kKeep chunks a lane, at most a warp. A
  // group converts its key's row once (kKeep chunks a lane stay in
  // registers) and dots it with every row's q.
  int LG = 1;
  while (LG * kKeep < nck && LG < 32) LG <<= 1;
  const int ngroups = kThreads / LG, grp = tid / LG, li = tid % LG;
  const int cv = Dv / VN;                 // 16 bytes of V's columns a thread
  int LR = 1;                             // softmax lanes a row
  while (LR < ps && LR < 32) LR <<= 1;
  const int ps4 = ps & ~3;
  // s / cap as s * (1 / cap), the reciprocal from the host: an f32 division
  // in the kernel calls its slow path, and the registers live across the
  // call spill
  const float inv_cap = p.inv_cap;

  for (int jj = 0; jj < n; ++jj) {
    issue_page<T>(p, sTab, jj + kSplitStages - 1, n, kh, k_base, v_base,
                  kp_base, kp_stride);
    if (sTab[jj] < 0) continue;           // the same for every thread
    cp_async_wait<kSplitStages - 1>();
    __syncthreads();                      // page jj (and q) in place
    const int st = jj % kSplitStages;
    const T* const sK = reinterpret_cast<const T*>(sm + L.k) + st * ps * kst;
    const T* const sV = reinterpret_cast<const T*>(sm + L.v) + st * ps * Dv;
    const int* const sKP =
        reinterpret_cast<const int*>(sm + L.kp) + st * kp_stride;

    // 1. scores: q.k (+ q2.k2) in f32, then scale, softcap, mask. bf16:
    //    one warp per (16-row tile, 8-key tile), m16n8k16 products over
    //    the padded rows (each bf16 product exact, f32 sums). f32: lane
    //    groups on the CUDA cores.
    if constexpr (kMma) {
      const int nt_n = (ps + 7) / 8, ksteps = (Dt + 15) / 16;
      const uint32_t q_base = smem_u32(sQ), k_base_st = smem_u32(sK);
      for (int task = warp; task < (R + 15) / 16 * nt_n;
           task += kThreads / 32) {
        const int mt = task / nt_n, nt = task % nt_n;
        const uint32_t qa =
            q_base + ((mt * 16 + lane % 16) * kst + (lane / 16) * 8) * 2;
        const uint32_t ka =
            k_base_st + ((nt * 8 + lane % 8) * kst + (lane / 8 % 2) * 8) * 2;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        for (int ks = 0; ks < ksteps; ++ks) {
          uint32_t a[4], bb[2];
          ldsm_x4(a, qa + ks * 32);
          ldsm_x2(bb, ka + ks * 32);
          mma_16816(d, a, bb);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = mt * 16 + lane / 4 + (e >> 1) * 8;
          const int jr = nt * 8 + 2 * (lane % 4) + (e & 1);
          if (rr < R && jr < ps) {
            float x = d[e] * p.scale;
            if (p.has_cap) x = p.cap * tanhf(x * inv_cap);
            sS[rr * sps + jr] = visible(sKP[jr], sQP[rr], p) ? x : kNegInf;
          }
        }
      }
    } else {
      for (int base = 0; base < ps; base += ngroups) {
        const int jr = base + grp;
        const T* const ka = sK + min(jr, ps - 1) * kst;
        float kf[kKeep][VN];
#pragma unroll
        for (int i = 0; i < kKeep; ++i) {
          const int c = li + i * LG;
          if (c < nck) to_float(*reinterpret_cast<const uint4*>(ka + c * VN),
                                kf[i]);
        }
        const int kp = sKP[min(jr, ps - 1)];
#pragma unroll 2
        for (int rr = 0; rr < R; ++rr) {
          const float* const qa = sQ + rr * Dt;
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < kKeep; ++i) {
            const int c = li + i * LG;
            if (c < nck) {
#pragma unroll
              for (int e = 0; e < VN; e += 4) {
                const float4 x =
                    *reinterpret_cast<const float4*>(qa + c * VN + e);
                s = fmaf(x.x, kf[i][e], s);
                s = fmaf(x.y, kf[i][e + 1], s);
                s = fmaf(x.z, kf[i][e + 2], s);
                s = fmaf(x.w, kf[i][e + 3], s);
              }
            }
          }
          for (int c = li + kKeep * LG; c < nck; c += LG) {   // wide rows
            float kx[VN];
            to_float(*reinterpret_cast<const uint4*>(ka + c * VN), kx);
#pragma unroll
            for (int e = 0; e < VN; ++e) s = fmaf(qa[c * VN + e], kx[e], s);
          }
          for (int off = LG / 2; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
          if (li == 0 && jr < ps) {
            s *= p.scale;
            if (p.has_cap) s = p.cap * tanhf(s * inv_cap);
            sS[rr * sps + jr] = visible(kp, sQP[rr], p) ? s : kNegInf;
          }
        }
      }
    }
    __syncthreads();

    // 2. online softmax, LR lanes a row (32 / LR rows a warp at once); p
    //    re-masked after the exp
    for (int r0 = warp * (32 / LR); r0 < R; r0 += kThreads / LR) {
      const int rr = r0 + lane / LR, lr = lane % LR;
      const bool row_ok = rr < R;
      float* const pr = sS + min(rr, R - 1) * sps;
      float mx = kNegInf;
      for (int jr = lr; jr < ps; jr += LR) mx = fmaxf(mx, pr[jr]);
      for (int off = LR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = row_ok ? sM[rr] : kNegInf;
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      const int qp = row_ok ? sQP[rr] : -1;
      float sum = 0.f;
      for (int jr = lr; jr < ps; jr += LR) {
        const float e = visible(sKP[jr], qp, p) ? expf(pr[jr] - m_new) : 0.f;
        if (row_ok) pr[jr] = e;
        sum += e;
      }
      for (int off = LR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lr == 0 && row_ok) {
        sL[rr] = sL[rr] * alpha + sum;
        sM[rr] = m_new;
        sAlpha[rr] = alpha;
      }
    }
    __syncthreads();

    // 3. acc = acc * alpha + p @ V, 16 bytes of V's columns a thread
    for (int idx = tid; idx < R * cv; idx += kThreads) {
      const int rr = idx / cv, c = idx % cv;
      float* const a = sAcc + rr * Dv + c * VN;
      const float al = sAlpha[rr];
      float acc[VN];
#pragma unroll
      for (int e = 0; e < VN; e += 4) {
        const float4 x = *reinterpret_cast<const float4*>(a + e);
        acc[e] = x.x * al;
        acc[e + 1] = x.y * al;
        acc[e + 2] = x.z * al;
        acc[e + 3] = x.w * al;
      }
      const float* const pr = sS + rr * sps;
      const T* const vc = sV + c * VN;
      for (int j4 = 0; j4 < ps4; j4 += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(pr + j4);
        const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float vf[VN];
          to_float(*reinterpret_cast<const uint4*>(vc + (j4 + u) * Dv), vf);
#pragma unroll
          for (int e = 0; e < VN; ++e) acc[e] = fmaf(w[u], vf[e], acc[e]);
        }
      }
      for (int jr = ps4; jr < ps; ++jr) {
        float vf[VN];
        to_float(*reinterpret_cast<const uint4*>(vc + jr * Dv), vf);
#pragma unroll
        for (int e = 0; e < VN; ++e) acc[e] = fmaf(pr[jr], vf[e], acc[e]);
      }
#pragma unroll
      for (int e = 0; e < VN; e += 4)
        *reinterpret_cast<float4*>(a + e) =
            make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
    }
    __syncthreads();                      // the stage may be reloaded
  }

  float* const w_acc = split_acc(p, ws);
  float* const w_ml = split_ml(p, ws);
  for (int idx = tid; idx < R * Dv; idx += kThreads) w_acc[idx] = sAcc[idx];
  for (int rr = tid; rr < R; rr += kThreads) {
    w_ml[rr] = sM[rr];
    w_ml[R + rr] = sL[rr];
  }
}

// One block per (row, kv head, slot): out = sum_i exp(m_i - m) acc_i /
// sum_i exp(m_i - m) l_i over the splits i with l_i > 0 (m their largest
// m_i); a row no split saw comes out as exact zeros. The splits' m and l
// are read once, in parallel, and their weights kept in shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const __grid_constant__ Params p,
                     const float* __restrict__ ws, int splits) {
  extern __shared__ float sW[];           // splits weights, then 4 warps' sums
  __shared__ float sRed[kThreads / 32];
  const int rr = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.K, R = p.S * G, Dv = p.Dv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t part0 = ((size_t)b * p.K + kh) * splits;
  const float* const w_ml = ws + (size_t)p.B * p.K * splits * R * Dv;

  float mx = -INFINITY;
  for (int i = tid; i < splits; i += kThreads) {
    const float* const ml = w_ml + (part0 + i) * 2 * R;
    const float m_i = ml[R + rr] > 0.f ? ml[rr] : -INFINITY;
    sW[i] = m_i;
    mx = fmaxf(mx, m_i);
  }
  mx = warp_max(mx);
  if (lane == 0) sRed[warp] = mx;
  __syncthreads();
  float m = sRed[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, sRed[w]);
  __syncthreads();                        // sRed is reused below
  float l = 0.f;
  for (int i = tid; i < splits; i += kThreads) {
    const float w_i = sW[i] > -INFINITY ? expf(sW[i] - m) : 0.f;
    sW[i] = w_i;
    l += w_i * w_ml[(part0 + i) * 2 * R + R + rr];
  }
  l = warp_sum(l);
  if (lane == 0) sRed[warp] = l;
  __syncthreads();
  l = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) l += sRed[w];
  const float den = l > 0.f ? l : 1.f;

  const size_t oi = (size_t)(b * p.S + rr / G) * p.H + kh * G + rr % G;
  const float* const acc = ws + (part0 * R + rr) * Dv;
  T* const out = static_cast<T*>(p.out);
  for (int d = tid; d < Dv; d += kThreads) {
    float a = 0.f;
#pragma unroll 4
    for (int i = 0; i < splits; ++i)
      if (sW[i] > 0.f) a += sW[i] * acc[(size_t)i * R * Dv + d];
    store(out, oi * Dv + d, a / den);
  }
}

template <typename T>
cudaError_t launch_split(const Params& p, float* ws, int splits, int per,
                         cudaStream_t stream) {
  const SplitLayout L = split_layout(p.S * (p.H / p.K), p.ps, p.Dk + p.Dk2,
                                     p.Dv, sizeof(T), per);
  if (L.total > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = paged_split_kernel<T>;
  if (L.total > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(splits, p.K, p.B), kThreads, L.total, stream>>>(p, ws, per);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t wbytes = (size_t)splits * 4;
  if (wbytes > kMaxSmem) return cudaErrorInvalidValue;
  if (wbytes > 48 * 1024) {
    e = cudaFuncSetAttribute(paged_combine_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)wbytes);
    if (e != cudaSuccess) return e;
  }
  paged_combine_kernel<T><<<dim3(p.S * (p.H / p.K), p.K, p.B), kThreads,
                            wbytes, stream>>>(p, ws, splits);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tile route: wgmma over key tiles gathered from pages (bf16)
// ---------------------------------------------------------------------------

constexpr int kTileThreads = 128 + 32;  // one consumer warpgroup + a producer
constexpr int kTileStages = 2;          // k/v ring
constexpr int kTileBars = 8 * (1 + 4 * kTileStages);
constexpr size_t kTwoBlocks = kMaxSmem / 2 - 1024;  // both fit on one SM
constexpr int kTileMaxRegs = 200;       // two blocks of 160 threads an SM
constexpr float kLog2e = 1.4426950408889634f;

inline int boxes(int d) { return (d + kBox - 1) / kBox; }

// Shared memory of a tile block without its table: 1 KB to align the
// swizzled tiles, q, the k and v rings, the kpos ring, the barriers and
// 16 bytes of block-wide values.
__host__ __device__ constexpr size_t tile_fixed_bytes(int ndk, int ndv,
                                                      int bk) {
  return 1024 + (size_t)kRows * ndk * kRowBytes +
         (size_t)kTileStages * bk * (ndk + ndv) * kRowBytes +
         (size_t)kTileStages * bk * 4 + kTileBars + 16;
}
// Keys a tile: 64 where the accumulator is at most 64 x 128 and two blocks
// fit on one SM; else 32.
__host__ __device__ constexpr int tile_bk(int ndk, int ndv) {
  return ndv <= 2 && tile_fixed_bytes(ndk, ndv, 64) <= kTwoBlocks ? 64 : 32;
}
// ... plus the slot's table (one int an entry) and the list of live tiles.
__host__ __device__ inline size_t tile_smem_bytes(int ndk, int ndv, int npps,
                                                  int ps) {
  const int bk = tile_bk(ndk, ndv);
  const int n_all = (npps * ps + bk - 1) / bk;
  return tile_fixed_bytes(ndk, ndv, bk) + align16((size_t)npps * 4) +
         align16((size_t)n_all * 4);
}

// This thread's fragment columns of a key tile (8*j + cq and + 1, key0 its
// first key): their kpos and their table entry (a page id, -1 dead), read
// from shared memory; the mla route reads them before it issues the scores'
// products, so that no load waits behind the tensor cores.
template <int BK>
struct TileKeys {
  int kp[BK / 8][2], t[BK / 8];
};
template <int BK>
__device__ __forceinline__ void tile_keys(TileKeys<BK>& k, const Params& p,
                                          const int* kp, const int* tab,
                                          int key0, int lgps, int cq) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const int col = 8 * j + cq, ent = (key0 + col) >> lgps;
    k.t[j] = ent < p.npps ? tab[ent] : -1;
    k.kp[j][0] = kp[col];
    k.kp[j][1] = kp[col + 1];
  }
}

// Scale, softcap and the mask on the S fragment of a key tile, then the
// online softmax (as flash_attention.cu's): p (f32) replaces s, m and l move
// on, alpha is what the accumulator is to be scaled by. A key is visible
// when its table entry is live and kpos passes `visible`.
template <int BK>
__device__ __forceinline__ void keys_softmax(
    float (&sc)[BK / 2], const Params& p, const TileKeys<BK>& k,
    const int (&qp)[2], float (&m)[2], float (&l)[2], float (&alpha)[2]) {
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) sc[e] *= p.scale;
  if (p.has_cap) {
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sc[e] = p.cap * tanhf(sc[e] / p.cap);
  }
  uint32_t vis = 0;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const bool live = k.t[j] >= 0;
    const int kp0 = live ? k.kp[j][0] : -1, kp1 = live ? k.kp[j][1] : -1;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (visible(e & 1 ? kp1 : kp0, qp[e >> 1], p))
        vis |= 1u << (4 * j + e);
      else
        sc[4 * j + e] = kNegInf;
    }
  }
  float mx[2] = {kNegInf, kNegInf}, mb[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < BK / 2; ++e)
    mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = ex2((m[r] - m_new) * kLog2e);
    m[r] = m_new;
    mb[r] = m_new * kLog2e;
  }
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    // exp(-1e30 - m_new) is 1 where the row has seen no key yet: re-mask
    // after the exp
    const float pe = ex2(fmaf(sc[e], kLog2e, -mb[(e >> 1) & 1]));
    sc[e] = (vis >> e & 1u) ? pe : 0.f;
    rs[(e >> 1) & 1] += sc[e];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
}

// keys_softmax on key tile `key0`'s keys, read here (the tile route).
template <int BK>
__device__ __forceinline__ void tile_softmax(
    float (&sc)[BK / 2], const Params& p, const int* kp, const int* tab,
    int key0, int lgps, const int (&qp)[2], int cq, float (&m)[2],
    float (&l)[2], float (&alpha)[2]) {
  TileKeys<BK> k;
  tile_keys<BK>(k, p, kp, tab, key0, lgps, cq);
  keys_softmax<BK>(sc, p, k, qp, m, l, alpha);
}

// Rows [0, BK) of one k or v tile by cp.async (pages of fewer than 8
// rows): key row n*BK + kr of the slot lies in table entry (n*BK + kr) / ps
// at row (n*BK + kr) % ps of that page; a row of a dead entry (or past the
// table) and the columns past D arrive as zeros. Chunk c (8 bf16) of row kr
// goes to box c / 8 at its swizzled place; a lane takes whole rows, so each
// row's address is computed once.
template <int ND, int BK>
__device__ __forceinline__ void copy_rows(uint32_t dst,
                                          const __nv_bfloat16* src, int D,
                                          const Params& p, const int* tab,
                                          int n, int lgps, int kh, int lane) {
  for (int kr = lane; kr < BK; kr += 32) {
    const int key = n * BK + kr, ent = key >> lgps;
    const int t = ent < p.npps ? tab[ent] : -1;
    const __nv_bfloat16* const row =
        src + (t >= 0 ? (((size_t)t * p.ps + (key & (p.ps - 1))) * p.K + kh)
                            * D : 0);
    const uint32_t d = dst + kr * kRowBytes;
#pragma unroll
    for (int c = 0; c < ND * 8; ++c) {
      const bool ok = t >= 0 && c * 8 < D;
      cp_async16(d + (c / 8) * BK * kRowBytes + (((c % 8) ^ (kr % 8)) * 16),
                 row + (ok ? c * 8 : 0), ok ? 16 : 0);
    }
  }
}

// The live pieces of key tile n by TMA (pages of 8 rows or more): piece j
// is `rows` = min(ps, BK) consecutive rows of one page, one box of rows x 64
// columns per column box, at row j * rows of the tile (a multiple of 8, so
// each box starts a swizzle atom). Called by one lane; the barrier expects
// the bytes of the pieces that are loaded.
template <int ND, int BK>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, const Params& p,
                                         const int* tab, int n, int lgps,
                                         int kh) {
  const int rows = min(p.ps, BK);
  int live = 0;
  for (int j = 0; j < BK / rows; ++j) {
    const int ent = (n * BK + j * rows) >> lgps;
    live += ent < p.npps && tab[ent] >= 0;
  }
  mbar_expect_tx(bar, live * ND * rows * kRowBytes);
  for (int j = 0; j < BK / rows; ++j) {
    const int key = n * BK + j * rows, ent = key >> lgps;
    const int t = ent < p.npps ? tab[ent] : -1;
    if (t < 0) continue;
    for (int c = 0; c < ND; ++c)
      tma_load(dst + (c * BK + j * rows) * kRowBytes, map, c * kBox, kh,
               t * p.ps + (key & (p.ps - 1)), bar);
  }
}

// NDK, NDV: 64-column boxes of Dk and Dv; BK keys a tile. Fragments as in
// flash_attention.cu: thread t of the warpgroup holds rows 16*(t/32) +
// (t%32)/4 and that + 8; element 4*j + e is column 8*j + 2*(t%4) + (e&1) of
// the first row (e < 2) or the second.
template <int NDK, int NDV, int BK = tile_bk(NDK, NDV)>
__global__ void __maxnreg__(kTileMaxRegs)
paged_tile_kernel(const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char tile_smem[];
  const uint32_t q_s = (smem_u32(tile_smem) + 1023) & ~1023u;
  unsigned char* const base = tile_smem + (q_s - smem_u32(tile_smem));
  const uint32_t k_s = q_s + kRows * NDK * kRowBytes;
  const uint32_t v_s = k_s + kTileStages * BK * NDK * kRowBytes;
  const uint32_t kp_s = v_s + kTileStages * BK * NDV * kRowBytes;
  // barriers: q landed; per stage, k landed / k used, v landed / v used
  const uint32_t q_full = kp_s + kTileStages * BK * 4;
  const uint32_t k_full = q_full + 8, k_free = k_full + 8 * kTileStages;
  const uint32_t v_full = k_free + 8 * kTileStages;
  const uint32_t v_free = v_full + 8 * kTileStages;
  int* const sKP = reinterpret_cast<int*>(base + (kp_s - q_s));
  int* const sMisc = reinterpret_cast<int*>(base + (v_free + 8 * kTileStages
                                                    - q_s));
  int* const sTab = sMisc + 4;            // the slot's table, live entries
  int* const sTiles = sTab + align16((size_t)p.npps * 4) / 4;

  const int b = blockIdx.z, kh = blockIdx.y;
  // row tiles last-first: the longest causal rows start in the first wave
  const int G = p.H / p.K, r0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int R = min(kRows, p.S * G - r0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lgps = __ffs(p.ps) - 1;
  const int n_all = (p.npps * p.ps + BK - 1) / BK;
  const bool tma = p.ps >= 8;             // k and v by TMA, else cp.async

  // the tile's first and last query positions (pad rows included: a pad
  // row sees what its -1 lets it see)
  if (warp == 0) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = lane; r < R; r += 32) {
      const int qp = p.q_pos[b * p.S + (r0 + r) / G];
      lo = min(lo, qp);
      hi = max(hi, qp);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (lane == 0) {
      sMisc[0] = lo;
      sMisc[1] = hi;
      // arrivals: the producer's 32 lanes after their cp.async copies (q;
      // kpos; k and v rows of small pages), and by TMA lane 0's
      // arrive.expect_tx (k and v of pages of 8 rows or more)
      mbar_init(q_full, 32);
      for (int s = 0; s < kTileStages; ++s) {
        mbar_init(k_full + 8 * s, tma ? 33 : 32);
        mbar_init(k_free + 8 * s, 4);     // one arrival per consumer warp
        mbar_init(v_full + 8 * s, tma ? 1 : 32);
        mbar_init(v_free + 8 * s, 4);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  if (tma) {
    // TMA leaves a dead page's rows as they were: start the v ring at zeros
    // so that p = 0 never meets a NaN left in shared memory
    uint4* const v_ring = reinterpret_cast<uint4*>(base + (v_s - q_s));
    for (int i = threadIdx.x; i < kTileStages * BK * NDV * 8;
         i += kTileThreads)
      v_ring[i] = make_uint4(0u, 0u, 0u, 0u);
    fence_proxy_async();
  }
  __syncthreads();

  if (warp == 4) {                        // q, while the others mark entries
    const __nv_bfloat16* const q = static_cast<const __nv_bfloat16*>(p.q);
    for (int r = lane; r < kRows; r += 32) {     // q: a lane takes rows
      const int row = r0 + r;
      const __nv_bfloat16* const qr =
          q + (r < R ? ((size_t)(b * p.S + row / G) * p.H + kh * G + row % G)
                           * p.Dk : 0);
#pragma unroll
      for (int c = 0; c < NDK * 8; ++c) {
        const bool ok = r < R && c * 8 < p.Dk;
        cp_async16(q_s + ((c / 8) * kRows + r) * kRowBytes +
                       (((c % 8) ^ (r % 8)) * 16),
                   qr + (ok ? c * 8 : 0), ok ? 16 : 0);
      }
    }
    cp_async_arrive(q_full);
  } else {
    // each table entry: its page id where some row of it is visible to
    // some row of the tile, else -1
    const int q_lo = sMisc[0], q_hi = sMisc[1];
    for (int j = threadIdx.x; j < p.npps; j += kTileThreads - 32) {
      int t = p.tables[b * p.npps + j];
      if (t >= 0 && t < p.P) {
        int k_lo = INT_MAX, k_hi = -1;
#pragma unroll 16
        for (int r = 0; r < p.ps; ++r) {
          const int kp = p.kpos[(size_t)t * p.ps + r];
          if (kp >= 0) {
            k_lo = min(k_lo, kp);
            k_hi = max(k_hi, kp);
          }
        }
        if (k_hi < 0 || (p.causal && k_lo > q_hi) ||
            (p.has_window && (long long)q_lo - k_hi >= p.window))
          t = -1;
      } else {
        t = -1;
      }
      sTab[j] = t;
    }
  }
  __syncthreads();

  // the key tiles that hold a live entry, in order
  if (warp == 0) {
    int count = 0;
    for (int n0 = 0; n0 < n_all; n0 += 32) {
      const int n = n0 + lane;
      bool live = false;
      if (n < n_all) {
        const int e1 = min(((n + 1) * BK - 1) >> lgps, p.npps - 1);
        for (int e = (n * BK) >> lgps; e <= e1; ++e) live |= sTab[e] >= 0;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      if (live) sTiles[count + __popc(mask & ((1u << lane) - 1))] = n;
      count += __popc(mask);
    }
    if (lane == 0) sMisc[2] = count;
  }
  __syncthreads();
  const int n_tiles = sMisc[2];

  if (warp == 4) {                        // the producer
    const __nv_bfloat16* const k = static_cast<const __nv_bfloat16*>(p.k);
    const __nv_bfloat16* const v = static_cast<const __nv_bfloat16*>(p.v);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kTileStages, n = sTiles[i];
      const uint32_t parity = (i / kTileStages - 1) & 1;
      if (i >= kTileStages) mbar_wait(k_free + 8 * s, parity);
      for (int kr = lane; kr < BK; kr += 32) {
        const int key = n * BK + kr, ent = key >> lgps;
        const int t = ent < p.npps ? sTab[ent] : -1;
        cp_async4(kp_s + (s * BK + kr) * 4,
                  p.kpos + (t >= 0 ? (size_t)t * p.ps + (key & (p.ps - 1))
                                   : 0),
                  t >= 0 ? 4 : 0);
      }
      const uint32_t kb = k_s + s * NDK * BK * kRowBytes;
      if (tma) {
        if (lane == 0)
          tma_tile<NDK, BK>(kb, &tk, k_full + 8 * s, p, sTab, n, lgps, kh);
      } else {
        copy_rows<NDK, BK>(kb, k, p.Dk, p, sTab, n, lgps, kh, lane);
      }
      cp_async_arrive(k_full + 8 * s);
      if (i >= kTileStages) mbar_wait(v_free + 8 * s, parity);
      const uint32_t vb = v_s + s * NDV * BK * kRowBytes;
      if (tma) {
        if (lane == 0)
          tma_tile<NDV, BK>(vb, &tv, v_full + 8 * s, p, sTab, n, lgps, kh);
      } else {
        copy_rows<NDV, BK>(vb, v, p.Dv, p, sTab, n, lgps, kh, lane);
        cp_async_arrive(v_full + 8 * s);
      }
    }
    cp_async_wait<0>();                   // exit with no copy in flight
    return;
  }

  // The consumer warpgroup, as flash_attention.cu's: tile i + 1's q @ k^T
  // runs on the tensor cores while tile i's P @ v does, and its softmax
  // while P @ v still runs. The k stage (with its kpos) is released after
  // the softmax has read the kpos. After each wait on a full barrier, a
  // proxy fence puts the cp.async writes before the wgmma reads.
  const int row = warp * 16 + lane / 4;             // and row + 8
  int qp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    qp[r] = row + 8 * r < R ? p.q_pos[b * p.S + (r0 + row + 8 * r) / G] : -1;
  const int cq = 2 * (lane % 4);
  float acc[NDV][32];
#pragma unroll
  for (int c = 0; c < NDV; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  float sc[BK / 2];
  uint32_t ph[BK / 16][4], pl[BK / 16][4];

  mbar_wait(q_full, 0);
  if (n_tiles > 0) {
    mbar_wait(k_full, 0);
    fence_proxy_async();
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sc[e] = 0.f;
    pin(sc);
    wg_fence();
    start_qk<NDK, BK>(sc, q_s, k_s);
    wg_wait<0>();
    pin(sc);
    tile_softmax<BK>(sc, p, sKP, sTab, sTiles[0] * BK, lgps, qp, cq, m, l,
                     alpha);
    if (lane == 0) mbar_arrive(k_free);
    split<BK>(sc, ph, pl);                // acc is zero: alpha needs no use
  }
  for (int i = 0; i + 1 < n_tiles; ++i) {
    const int s = i % kTileStages, t = (i + 1) % kTileStages;
    mbar_wait(k_full + 8 * t, ((i + 1) / kTileStages) & 1);
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sc[e] = 0.f;
    mbar_wait(v_full + 8 * s, (i / kTileStages) & 1);
    fence_proxy_async();
    pin(sc);
#pragma unroll
    for (int c = 0; c < NDV; ++c) pin(acc[c]);
    pin(ph);
    pin(pl);
    wg_fence();
    start_qk<NDK, BK>(sc, q_s, k_s + t * NDK * BK * kRowBytes);
    start_pv<NDV, BK>(acc, ph, pl, v_s + s * NDV * BK * kRowBytes);
    wg_wait<1>();                         // tile i + 1's scores are in
    pin(sc);
    tile_softmax<BK>(sc, p, sKP + t * BK, sTab, sTiles[i + 1] * BK, lgps, qp,
                     cq, m, l, alpha);
    if (lane == 0) mbar_arrive(k_free + 8 * t);
    wg_wait<0>();                         // tile i's P @ v is in
#pragma unroll
    for (int c = 0; c < NDV; ++c) pin(acc[c]);
    pin(ph);
    pin(pl);
    if (lane == 0) mbar_arrive(v_free + 8 * s);
#pragma unroll
    for (int c = 0; c < NDV; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] *= alpha[(e >> 1) & 1];
    split<BK>(sc, ph, pl);
  }
  if (n_tiles > 0) {                      // the last tile's P @ v
    const int i = n_tiles - 1;
    mbar_wait(v_full + 8 * (i % kTileStages), (i / kTileStages) & 1);
    fence_proxy_async();
#pragma unroll
    for (int c = 0; c < NDV; ++c) pin(acc[c]);
    pin(ph);
    pin(pl);
    wg_fence();
    start_pv<NDV, BK>(acc, ph, pl,
                      v_s + (i % kTileStages) * NDV * BK * kRowBytes);
    wg_wait<0>();
#pragma unroll
    for (int c = 0; c < NDV; ++c) pin(acc[c]);
  }

  __nv_bfloat16* const O = static_cast<__nv_bfloat16*>(p.out);
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    den[r] = l[r] > 0.f ? l[r] : 1.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r, orow = r0 + rr;
    if (rr >= R) continue;
    const size_t oi =
        ((size_t)(b * p.S + orow / G) * p.H + kh * G + orow % G) * p.Dv;
#pragma unroll
    for (int c = 0; c < NDV; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * kBox + 8 * j + cq;
        if (col < p.Dv)
          *reinterpret_cast<__nv_bfloat162*>(O + oi + col) =
              __floats2bfloat162_rn(acc[c][4 * j + 2 * r] / den[r],
                                    acc[c][4 * j + 2 * r + 1] / den[r]);
      }
  }
}

template <int NDK, int NDV>
cudaError_t launch_tile(const Params& p, cudaStream_t stream) {
  constexpr int BK = tile_bk(NDK, NDV);
  const size_t smem = tile_smem_bytes(NDK, NDV, p.npps, p.ps);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // the pools as (D, K, P*ps) tensors, in boxes of 64 columns x 1 head x
  // min(ps, BK) rows (used where ps >= 8)
  CUtensorMap tk{}, tv{};
  if (p.ps >= 8) {
    const cuuint64_t rows = (cuuint64_t)p.P * p.ps;
    const cuuint32_t box_rows = (cuuint32_t)(p.ps < BK ? p.ps : BK);
    if (!tensor_map_3d(&tk, p.k, {(cuuint64_t)p.Dk, (cuuint64_t)p.K, rows},
                       {(cuuint64_t)p.Dk * 2, (cuuint64_t)p.K * p.Dk * 2},
                       {kBox, 1, box_rows}) ||
        !tensor_map_3d(&tv, p.v, {(cuuint64_t)p.Dv, (cuuint64_t)p.K, rows},
                       {(cuuint64_t)p.Dv * 2, (cuuint64_t)p.K * p.Dv * 2},
                       {kBox, 1, box_rows}))
      return cudaErrorInvalidValue;
  }
  auto kern = paged_tile_kernel<NDK, NDV>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.S * (p.H / p.K) + kRows - 1) / kRows, p.K, p.B);
  kern<<<grid, kTileThreads, smem, stream>>>(tk, tv, p);
  return cudaGetLastError();
}

using TileLaunch = cudaError_t (*)(const Params&, cudaStream_t);
template <int NDK>
constexpr TileLaunch kTileRow[4] = {launch_tile<NDK, 1>, launch_tile<NDK, 2>,
                                    launch_tile<NDK, 3>, launch_tile<NDK, 4>};

cudaError_t dispatch_tile(const Params& p, cudaStream_t stream) {
  static const TileLaunch* const rows[4] = {kTileRow<1>, kTileRow<2>,
                                            kTileRow<3>, kTileRow<4>};
  return rows[boxes(p.Dk) - 1][boxes(p.Dv) - 1](p, stream);
}

// ---------------------------------------------------------------------------
// mla route: MLA's absorbed form on wgmma, one staged ckv tile as K and V
// ---------------------------------------------------------------------------

constexpr int kMlaBK = 32;              // keys a tile
constexpr int kMlaStages = 3;           // [ckv | kr] ring
// two consumer warpgroups and a producer warpgroup (one warp of it copies):
// registers are set a warpgroup at a time (setmaxnreg), and an SM allots
// them to warps in groups of four
constexpr int kMlaThreads = 3 * 128;
constexpr int kMlaNW = kMlaBK / 16;     // k16 steps of P @ V a tile
// registers a thread: 168 at launch (384 x 168 = 64,512 of an SM's 65,536;
// one block an SM, as its shared memory allows no second), then 40 in the
// producer warpgroup and 232 in the consumers (128 x 40 + 256 x 232 =
// 64,512): 211 at Dk 512, no spill
constexpr int kMlaProducerRegs = 40, kMlaConsumerRegs = 232;

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
// the P buffers: per buffer and thread, NW uint4 of P_hi then NW of P_lo
constexpr size_t kMlaPBytes = 2 * (size_t)2 * kMlaNW * 128 * 16;
constexpr size_t kMlaAlphaBytes = 2 * 128 * 8;   // alpha, per buffer
constexpr size_t kMlaLBytes = 128 * 8;           // the final l
// barriers: q landed; per stage tile landed / tile used; per P buffer
// full / free (11 x 8 bytes), then 16 bytes of block-wide values
constexpr int kMlaBars = 96;

// Shared memory of an mla block: 1 KB to align the swizzled tiles, the
// [q | q2] tile, the [ckv | kr] ring, the P buffers, l, the kpos ring, the
// barriers and block-wide values, the table and the list of live tiles.
__host__ __device__ inline size_t mla_smem_bytes(int ndk, int npps, int ps) {
  const int n_all = (int)(((long long)npps * ps + kMlaBK - 1) / kMlaBK);
  return 1024 + (size_t)kRows * (ndk + 1) * kRowBytes +
         (size_t)kMlaStages * kMlaBK * (ndk + 1) * kRowBytes + kMlaPBytes +
         kMlaAlphaBytes + kMlaLBytes + (size_t)kMlaStages * kMlaBK * 4 +
         kMlaBars + 16 + align16((size_t)npps * 4) +
         align16((size_t)n_all * 4);
}

// The live pieces of key tile n of [ckv | kr] by TMA: piece j is `rows` =
// min(ps, BK) consecutive rows of one page, NDK boxes of ckv and one of kr
// (columns past Dk2 arrive as zeros) at row j * rows of each box. Called by
// one lane; the barrier expects the bytes of the pieces that are loaded.
template <int NDK>
__device__ __forceinline__ void tma_mla_tile(uint32_t dst,
                                             const CUtensorMap* tk,
                                             const CUtensorMap* tk2,
                                             uint32_t bar, const Params& p,
                                             const int* tab, int n, int lgps,
                                             int kh) {
  constexpr int BK = kMlaBK;
  const int rows = min(p.ps, BK);
  int live = 0;
  for (int j = 0; j < BK / rows; ++j) {
    const int ent = (n * BK + j * rows) >> lgps;
    live += ent < p.npps && tab[ent] >= 0;
  }
  mbar_expect_tx(bar, live * (NDK + 1) * rows * kRowBytes);
  for (int j = 0; j < BK / rows; ++j) {
    const int key = n * BK + j * rows, ent = key >> lgps;
    const int t = ent < p.npps ? tab[ent] : -1;
    if (t < 0) continue;
    const int row = t * p.ps + (key & (p.ps - 1));
#pragma unroll
    for (int c = 0; c < NDK; ++c)
      tma_load(dst + (c * BK + j * rows) * kRowBytes, tk, c * kBox, kh, row,
               bar);
    tma_load(dst + (NDK * BK + j * rows) * kRowBytes, tk2, 0, kh, row, bar);
  }
}

// d (64 x 64*NV, f32; NV boxes of 64 columns, box c in d[c]) += a (64 x 16,
// bf16 fragment in registers) @ b (16 x 64*NV, bf16 in shared memory,
// MN-major: the transpose bit; `b`'s leading offset steps from one box of
// 64 columns to the next): one wgmma for all of a warpgroup's value
// columns (NV = 1 is hopper.cuh's mma_rs).
template <int NV>
__device__ __forceinline__ void mma_rs_wide(float (&d)[NV][32],
                                            const uint32_t (&a)[4],
                                            uint64_t b);
template <>
__device__ __forceinline__ void mma_rs_wide<2>(float (&d)[2][32],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, "
      "%67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[0][4]), "+f"(d[0][5]), "+f"(d[0][6]), "+f"(d[0][7]),
        "+f"(d[0][8]), "+f"(d[0][9]), "+f"(d[0][10]), "+f"(d[0][11]),
        "+f"(d[0][12]), "+f"(d[0][13]), "+f"(d[0][14]), "+f"(d[0][15]),
        "+f"(d[0][16]), "+f"(d[0][17]), "+f"(d[0][18]), "+f"(d[0][19]),
        "+f"(d[0][20]), "+f"(d[0][21]), "+f"(d[0][22]), "+f"(d[0][23]),
        "+f"(d[0][24]), "+f"(d[0][25]), "+f"(d[0][26]), "+f"(d[0][27]),
        "+f"(d[0][28]), "+f"(d[0][29]), "+f"(d[0][30]), "+f"(d[0][31]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[1][4]), "+f"(d[1][5]), "+f"(d[1][6]), "+f"(d[1][7]),
        "+f"(d[1][8]), "+f"(d[1][9]), "+f"(d[1][10]), "+f"(d[1][11]),
        "+f"(d[1][12]), "+f"(d[1][13]), "+f"(d[1][14]), "+f"(d[1][15]),
        "+f"(d[1][16]), "+f"(d[1][17]), "+f"(d[1][18]), "+f"(d[1][19]),
        "+f"(d[1][20]), "+f"(d[1][21]), "+f"(d[1][22]), "+f"(d[1][23]),
        "+f"(d[1][24]), "+f"(d[1][25]), "+f"(d[1][26]), "+f"(d[1][27]),
        "+f"(d[1][28]), "+f"(d[1][29]), "+f"(d[1][30]), "+f"(d[1][31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs_wide<3>(float (&d)[3][32],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[0][4]), "+f"(d[0][5]), "+f"(d[0][6]), "+f"(d[0][7]),
        "+f"(d[0][8]), "+f"(d[0][9]), "+f"(d[0][10]), "+f"(d[0][11]),
        "+f"(d[0][12]), "+f"(d[0][13]), "+f"(d[0][14]), "+f"(d[0][15]),
        "+f"(d[0][16]), "+f"(d[0][17]), "+f"(d[0][18]), "+f"(d[0][19]),
        "+f"(d[0][20]), "+f"(d[0][21]), "+f"(d[0][22]), "+f"(d[0][23]),
        "+f"(d[0][24]), "+f"(d[0][25]), "+f"(d[0][26]), "+f"(d[0][27]),
        "+f"(d[0][28]), "+f"(d[0][29]), "+f"(d[0][30]), "+f"(d[0][31]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[1][4]), "+f"(d[1][5]), "+f"(d[1][6]), "+f"(d[1][7]),
        "+f"(d[1][8]), "+f"(d[1][9]), "+f"(d[1][10]), "+f"(d[1][11]),
        "+f"(d[1][12]), "+f"(d[1][13]), "+f"(d[1][14]), "+f"(d[1][15]),
        "+f"(d[1][16]), "+f"(d[1][17]), "+f"(d[1][18]), "+f"(d[1][19]),
        "+f"(d[1][20]), "+f"(d[1][21]), "+f"(d[1][22]), "+f"(d[1][23]),
        "+f"(d[1][24]), "+f"(d[1][25]), "+f"(d[1][26]), "+f"(d[1][27]),
        "+f"(d[1][28]), "+f"(d[1][29]), "+f"(d[1][30]), "+f"(d[1][31]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[2][4]), "+f"(d[2][5]), "+f"(d[2][6]), "+f"(d[2][7]),
        "+f"(d[2][8]), "+f"(d[2][9]), "+f"(d[2][10]), "+f"(d[2][11]),
        "+f"(d[2][12]), "+f"(d[2][13]), "+f"(d[2][14]), "+f"(d[2][15]),
        "+f"(d[2][16]), "+f"(d[2][17]), "+f"(d[2][18]), "+f"(d[2][19]),
        "+f"(d[2][20]), "+f"(d[2][21]), "+f"(d[2][22]), "+f"(d[2][23]),
        "+f"(d[2][24]), "+f"(d[2][25]), "+f"(d[2][26]), "+f"(d[2][27]),
        "+f"(d[2][28]), "+f"(d[2][29]), "+f"(d[2][30]), "+f"(d[2][31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs_wide<4>(float (&d)[4][32],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[0][4]), "+f"(d[0][5]), "+f"(d[0][6]), "+f"(d[0][7]),
        "+f"(d[0][8]), "+f"(d[0][9]), "+f"(d[0][10]), "+f"(d[0][11]),
        "+f"(d[0][12]), "+f"(d[0][13]), "+f"(d[0][14]), "+f"(d[0][15]),
        "+f"(d[0][16]), "+f"(d[0][17]), "+f"(d[0][18]), "+f"(d[0][19]),
        "+f"(d[0][20]), "+f"(d[0][21]), "+f"(d[0][22]), "+f"(d[0][23]),
        "+f"(d[0][24]), "+f"(d[0][25]), "+f"(d[0][26]), "+f"(d[0][27]),
        "+f"(d[0][28]), "+f"(d[0][29]), "+f"(d[0][30]), "+f"(d[0][31]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[1][4]), "+f"(d[1][5]), "+f"(d[1][6]), "+f"(d[1][7]),
        "+f"(d[1][8]), "+f"(d[1][9]), "+f"(d[1][10]), "+f"(d[1][11]),
        "+f"(d[1][12]), "+f"(d[1][13]), "+f"(d[1][14]), "+f"(d[1][15]),
        "+f"(d[1][16]), "+f"(d[1][17]), "+f"(d[1][18]), "+f"(d[1][19]),
        "+f"(d[1][20]), "+f"(d[1][21]), "+f"(d[1][22]), "+f"(d[1][23]),
        "+f"(d[1][24]), "+f"(d[1][25]), "+f"(d[1][26]), "+f"(d[1][27]),
        "+f"(d[1][28]), "+f"(d[1][29]), "+f"(d[1][30]), "+f"(d[1][31]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[2][4]), "+f"(d[2][5]), "+f"(d[2][6]), "+f"(d[2][7]),
        "+f"(d[2][8]), "+f"(d[2][9]), "+f"(d[2][10]), "+f"(d[2][11]),
        "+f"(d[2][12]), "+f"(d[2][13]), "+f"(d[2][14]), "+f"(d[2][15]),
        "+f"(d[2][16]), "+f"(d[2][17]), "+f"(d[2][18]), "+f"(d[2][19]),
        "+f"(d[2][20]), "+f"(d[2][21]), "+f"(d[2][22]), "+f"(d[2][23]),
        "+f"(d[2][24]), "+f"(d[2][25]), "+f"(d[2][26]), "+f"(d[2][27]),
        "+f"(d[2][28]), "+f"(d[2][29]), "+f"(d[2][30]), "+f"(d[2][31]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[3][4]), "+f"(d[3][5]), "+f"(d[3][6]), "+f"(d[3][7]),
        "+f"(d[3][8]), "+f"(d[3][9]), "+f"(d[3][10]), "+f"(d[3][11]),
        "+f"(d[3][12]), "+f"(d[3][13]), "+f"(d[3][14]), "+f"(d[3][15]),
        "+f"(d[3][16]), "+f"(d[3][17]), "+f"(d[3][18]), "+f"(d[3][19]),
        "+f"(d[3][20]), "+f"(d[3][21]), "+f"(d[3][22]), "+f"(d[3][23]),
        "+f"(d[3][24]), "+f"(d[3][25]), "+f"(d[3][26]), "+f"(d[3][27]),
        "+f"(d[3][28]), "+f"(d[3][29]), "+f"(d[3][30]), "+f"(d[3][31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// acc += P_hi @ v + P_lo @ v for one key tile, started and committed, on a
// warpgroup's NV boxes of value columns at vb (boxes BK rows apart): one
// wgmma a k16 step and term (start_pv issues one a box).
template <int NV, int BK>
__device__ __forceinline__ void start_pv_wide(float (&acc)[NV][32],
                                              const uint32_t (&ph)[BK / 16][4],
                                              const uint32_t (&pl)[BK / 16][4],
                                              uint32_t vb) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv =
        (desc(vb + kk * 16 * kRowBytes) & ~((uint64_t)0x3FFF << 16)) |
        ((uint64_t)((BK * kRowBytes) >> 4) << 16);   // leading offset: a box
    if constexpr (NV == 1) {
      mma_rs(acc[0], ph[kk], dv);
      mma_rs(acc[0], pl[kk], dv);
    } else {
      mma_rs_wide<NV>(acc, ph[kk], dv);
      mma_rs_wide<NV>(acc, pl[kk], dv);
    }
  }
  wg_commit();
}

// Warpgroup 0's hand-over of tile i: P_hi, P_lo (A fragments, thread tw's
// registers) and alpha into buffer i % 2, once warpgroup 1 has taken tile
// i - 2 from it; then its arrival on the buffer's full barrier.
__device__ __forceinline__ void mla_publish(
    uint4* sP, float2* sA, uint32_t p_full, uint32_t p_free, int i, int tw,
    const uint32_t (&ph)[kMlaNW][4], const uint32_t (&pl)[kMlaNW][4],
    const float (&alpha)[2]) {
  const int buf = i & 1;
  if (i >= 2) mbar_wait(p_free + 8 * buf, (i / 2 - 1) & 1);
  uint4* const P = sP + buf * 2 * kMlaNW * 128;
#pragma unroll
  for (int kk = 0; kk < kMlaNW; ++kk) {
    P[kk * 128 + tw] = make_uint4(ph[kk][0], ph[kk][1], ph[kk][2], ph[kk][3]);
    P[(kMlaNW + kk) * 128 + tw] =
        make_uint4(pl[kk][0], pl[kk][1], pl[kk][2], pl[kk][3]);
  }
  sA[buf * 128 + tw] = make_float2(alpha[0], alpha[1]);
  mbar_arrive(p_full + 8 * buf);
}

// NDK: 64-column boxes of Dk (= Dv). Warpgroup w owns value boxes [w * NV,
// w * NV + NV); where NDK is odd, warpgroup 1's last box is the kr box,
// whose product is never stored. Fragments as in the tile route: thread t
// of a warpgroup holds rows 16*(t/32) + (t%32)/4 and that + 8.
template <int NDK>
__global__ void __launch_bounds__(kMlaThreads, 1)
paged_mla_kernel(const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tk2,
                 const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tq2,
                 const __grid_constant__ Params p, float* __restrict__ ws,
                 int splits, int per) {
  constexpr int ND = NDK + 1;             // boxes of [q | q2] and [ckv | kr]
  constexpr int NV = (NDK + 1) / 2;       // value boxes of a warpgroup
  constexpr int BK = kMlaBK, NW = kMlaNW;
  extern __shared__ __align__(1024) unsigned char mla_smem[];
  const uint32_t q_s = (smem_u32(mla_smem) + 1023) & ~1023u;
  unsigned char* const base = mla_smem + (q_s - smem_u32(mla_smem));
  const uint32_t k_s = q_s + kRows * ND * kRowBytes;
  const uint32_t p_s = k_s + kMlaStages * BK * ND * kRowBytes;
  const uint32_t a_s = p_s + (uint32_t)kMlaPBytes;
  const uint32_t l_s = a_s + (uint32_t)kMlaAlphaBytes;
  const uint32_t kp_s = l_s + (uint32_t)kMlaLBytes;
  const uint32_t q_full = kp_s + kMlaStages * BK * 4;
  const uint32_t k_full = q_full + 8, k_free = k_full + 8 * kMlaStages;
  const uint32_t p_full = k_free + 8 * kMlaStages, p_free = p_full + 16;
  int* const sKP = reinterpret_cast<int*>(base + (kp_s - q_s));
  int* const sMisc = reinterpret_cast<int*>(base + (q_full + kMlaBars - q_s));
  int* const sTab = sMisc + 4;            // the table: live entries, else -1
  int* const sTiles = sTab + align16((size_t)p.npps * 4) / 4;

  const int b = blockIdx.z / p.K, kh = blockIdx.z % p.K, sp = blockIdx.y;
  // row tiles last-first: the longest causal rows start in the first wave
  const int G = p.H / p.K, Rt = p.S * G;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int R = min(kRows, Rt - r0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lgps = __ffs(p.ps) - 1;
  const int n_all = (p.npps * p.ps + BK - 1) / BK;
  // where G is a multiple of 64 the tile's rows are 64 heads of one query:
  // q and q2 by TMA, else by cp.async
  const bool q_tma = G % kRows == 0;
  // this block's key tiles and the table entries they span
  const int t0 = sp * per, t1 = min(n_all, t0 + per);
  const int e0 = min(p.npps, (t0 * BK) >> lgps);
  const int e1 = t1 > t0 ? min(p.npps, ((t1 * BK - 1) >> lgps) + 1) : e0;

  if (threadIdx.x == 256) {               // the producer's lane 0
    // arrivals: q's arrive.expect_tx (TMA) or the 256 consumer threads
    // after their q copies; per stage the producer's 32 lanes after the
    // kpos copies + lane 0's arrive.expect_tx, and one per consumer warp
    // when a tile is used; per P buffer warpgroup 0's 128 threads (full),
    // warpgroup 1's (free)
    mbar_init(q_full, q_tma ? 1 : 256);
    for (int s = 0; s < kMlaStages; ++s) {
      mbar_init(k_full + 8 * s, 33);
      mbar_init(k_free + 8 * s, 8);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(p_full + 8 * s, 128);
      mbar_init(p_free + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (q_tma) {                          // [q | q2] at once
      const int qh = kh * G + r0 % G, qr = b * p.S + r0 / G;
      mbar_expect_tx(q_full, ND * kRows * kRowBytes);
#pragma unroll
      for (int c = 0; c < NDK; ++c)
        tma_load(q_s + c * kRows * kRowBytes, &tq, c * kBox, qh, qr, q_full);
      tma_load(q_s + NDK * kRows * kRowBytes, &tq2, 0, qh, qr, q_full);
    }
  }
  {
    // TMA leaves a dead entry's rows as they were: start the ring at zeros
    // so that p = 0 never meets a NaN left in shared memory
    uint4* const ring = reinterpret_cast<uint4*>(base + (k_s - q_s));
    for (int i = threadIdx.x; i < kMlaStages * BK * ND * 8; i += kMlaThreads)
      ring[i] = make_uint4(0u, 0u, 0u, 0u);
    fence_proxy_async();
  }
  {
    // in every warp, the tile's first and last query positions (pad rows
    // included); then each entry of the range, a warp an entry and a lane
    // a row: its page id where some row of it is visible to some row of
    // the tile, else -1
    int q_lo = INT_MAX, q_hi = INT_MIN;
    for (int r = lane; r < R; r += 32) {
      const int qp = p.q_pos[b * p.S + (r0 + r) / G];
      q_lo = min(q_lo, qp);
      q_hi = max(q_hi, qp);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      q_lo = min(q_lo, __shfl_xor_sync(0xffffffffu, q_lo, off));
      q_hi = max(q_hi, __shfl_xor_sync(0xffffffffu, q_hi, off));
    }
    for (int j = e0 + warp; j < e1; j += kMlaThreads / 32) {
      int t = p.tables[b * p.npps + j];
      t = (t >= 0 && t < p.P) ? t : -1;
      int k_lo = INT_MAX, k_hi = -1;
      for (int r = lane; t >= 0 && r < p.ps; r += 32) {
        const int kp = p.kpos[(size_t)t * p.ps + r];
        if (kp >= 0) {
          k_lo = min(k_lo, kp);
          k_hi = max(k_hi, kp);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        k_lo = min(k_lo, __shfl_xor_sync(0xffffffffu, k_lo, off));
        k_hi = max(k_hi, __shfl_xor_sync(0xffffffffu, k_hi, off));
      }
      if (k_hi < 0 || (p.causal && k_lo > q_hi) ||
          (p.has_window && (long long)q_lo - k_hi >= p.window))
        t = -1;
      if (lane == 0) sTab[j] = t;
    }
  }
  __syncthreads();

  if (!q_tma && warp < 8) {               // [q | q2] by the consumer threads
    const __nv_bfloat16* const q = static_cast<const __nv_bfloat16*>(p.q);
    const __nv_bfloat16* const q2 = static_cast<const __nv_bfloat16*>(p.q2);
    for (int idx = threadIdx.x; idx < kRows * ND * 8; idx += 256) {
      const int r = idx / (ND * 8), c = idx % (ND * 8);
      const int box = c / 8, cc = c % 8, row = r0 + r;
      const __nv_bfloat16* src = q;
      bool ok = r < R;
      if (ok) {
        const size_t qi =
            (size_t)(b * p.S + row / G) * p.H + kh * G + row % G;
        if (box < NDK) {
          src = q + qi * p.Dk + c * 8;
        } else {
          ok = cc * 8 < p.Dk2;
          src = q2 + qi * p.Dk2 + (ok ? cc * 8 : 0);
        }
      }
      cp_async16(q_s + (box * kRows + r) * kRowBytes + ((cc ^ (r % 8)) * 16),
                 src, ok ? 16 : 0);
    }
    cp_async_arrive(q_full);
  }

  // the key tiles of the range that hold a live entry, in order
  if (warp == 0) {
    int count = 0;
    for (int n0 = t0; n0 < t1; n0 += 32) {
      const int n = n0 + lane;
      bool live = false;
      if (n < t1) {
        const int ea = (n * BK) >> lgps;
        const int eb = min(((n + 1) * BK - 1) >> lgps, p.npps - 1);
        for (int e = ea; e <= eb; ++e) live |= sTab[e] >= 0;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      if (live) sTiles[count + __popc(mask & ((1u << lane) - 1))] = n;
      count += __popc(mask);
    }
    if (lane == 0) sMisc[0] = count;
  }
  __syncthreads();
  const int n_tiles = sMisc[0];

  if (warp >= 8) {                        // the producer warpgroup
    reg_dealloc<kMlaProducerRegs>();
    if (warp > 8) return;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kMlaStages, n = sTiles[i];
      if (i >= kMlaStages) mbar_wait(k_free + 8 * s, (i / kMlaStages - 1) & 1);
      for (int kr = lane; kr < BK; kr += 32) {
        const int key = n * BK + kr, ent = key >> lgps;
        const int t = ent < p.npps ? sTab[ent] : -1;
        cp_async4(kp_s + (s * BK + kr) * 4,
                  p.kpos + (t >= 0 ? (size_t)t * p.ps + (key & (p.ps - 1))
                                   : 0),
                  t >= 0 ? 4 : 0);
      }
      if (lane == 0)
        tma_mla_tile<NDK>(k_s + s * ND * BK * kRowBytes, &tk, &tk2,
                          k_full + 8 * s, p, sTab, n, lgps, kh);
      cp_async_arrive(k_full + 8 * s);
    }
    cp_async_wait<0>();                   // exit with no copy in flight
    return;
  }
  reg_alloc<kMlaConsumerRegs>();

  const int wg = warp / 4, tw = threadIdx.x % 128;
  const int row = (warp % 4) * 16 + lane / 4;       // and row + 8
  const int cq = 2 * (lane % 4);
  const uint32_t v_off = wg * NV * BK * kRowBytes;  // this warpgroup's boxes
  uint4* const sP = reinterpret_cast<uint4*>(base + (p_s - q_s));
  float2* const sA = reinterpret_cast<float2*>(base + (a_s - q_s));
  float2* const sL = reinterpret_cast<float2*>(base + (l_s - q_s));
  float acc[NV][32];
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
  uint32_t ph[NW][4], pl[NW][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (wg == 0) {
    // Scores, softmax and this half of P @ V; tile i + 1's S runs on the
    // tensor cores while tile i's P @ V does, and P(i + 1) is handed over
    // once P(i) @ V is in (ph / pl are its operands until then).
    int qp[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      qp[r] = row + 8 * r < R ? p.q_pos[b * p.S + (r0 + row + 8 * r) / G]
                              : -1;
    float alpha[2], sc[BK / 2];
    mbar_wait(q_full, 0);
    if (n_tiles > 0) {
      mbar_wait(k_full, 0);
      fence_proxy_async();                // q's cp.async before wgmma reads
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) sc[e] = 0.f;
      pin(sc);
      wg_fence();
      start_qk<ND, BK>(sc, q_s, k_s);
      wg_wait<0>();
      pin(sc);
      tile_softmax<BK>(sc, p, sKP, sTab, sTiles[0] * BK, lgps, qp, cq, m, l,
                       alpha);
      split<BK>(sc, ph, pl);              // acc is zero: alpha needs no use
      mla_publish(sP, sA, p_full, p_free, 0, tw, ph, pl, alpha);
    }
    for (int i = 0; i + 1 < n_tiles; ++i) {
      const int s = i % kMlaStages, t = (i + 1) % kMlaStages;
      mbar_wait(k_full + 8 * t, ((i + 1) / kMlaStages) & 1);
      TileKeys<BK> keys;                  // read while the products run
      tile_keys<BK>(keys, p, sKP + t * BK, sTab, sTiles[i + 1] * BK, lgps,
                    cq);
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) sc[e] = 0.f;
      pin(sc);
#pragma unroll
      for (int c = 0; c < NV; ++c) pin(acc[c]);
      pin(ph);
      pin(pl);
      wg_fence();
      start_qk<ND, BK>(sc, q_s, k_s + t * ND * BK * kRowBytes);
      start_pv_wide<NV, BK>(acc, ph, pl,
                            k_s + s * ND * BK * kRowBytes + v_off);
      wg_wait<1>();                       // tile i + 1's scores are in
      pin(sc);
      keys_softmax<BK>(sc, p, keys, qp, m, l, alpha);
      wg_wait<0>();                       // tile i's P @ V is in
#pragma unroll
      for (int c = 0; c < NV; ++c) pin(acc[c]);
      pin(ph);
      pin(pl);
      if (lane == 0) mbar_arrive(k_free + 8 * s);
      split<BK>(sc, ph, pl);              // P(i + 1) first: warpgroup 1 waits
      mla_publish(sP, sA, p_full, p_free, i + 1, tw, ph, pl, alpha);
#pragma unroll
      for (int c = 0; c < NV; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[c][e] *= alpha[(e >> 1) & 1];
    }
    if (n_tiles > 0) {                    // the last tile's P @ V
      const int s = (n_tiles - 1) % kMlaStages;
#pragma unroll
      for (int c = 0; c < NV; ++c) pin(acc[c]);
      pin(ph);
      pin(pl);
      wg_fence();
      start_pv_wide<NV, BK>(acc, ph, pl,
                            k_s + s * ND * BK * kRowBytes + v_off);
      wg_wait<0>();
#pragma unroll
      for (int c = 0; c < NV; ++c) pin(acc[c]);
      if (lane == 0) mbar_arrive(k_free + 8 * s);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    sL[tw] = make_float2(l[0], l[1]);
  } else {
    // The other half of P @ V, on P and alpha from warpgroup 0.
    for (int i = 0; i < n_tiles; ++i) {
      const int buf = i & 1, s = i % kMlaStages;
      mbar_wait(p_full + 8 * buf, (i / 2) & 1);
      const uint4* const P = sP + buf * 2 * NW * 128;
#pragma unroll
      for (int kk = 0; kk < NW; ++kk) {
        const uint4 h = P[kk * 128 + tw], lo = P[(NW + kk) * 128 + tw];
        ph[kk][0] = h.x, ph[kk][1] = h.y, ph[kk][2] = h.z, ph[kk][3] = h.w;
        pl[kk][0] = lo.x, pl[kk][1] = lo.y, pl[kk][2] = lo.z,
        pl[kk][3] = lo.w;
      }
      const float2 al = sA[buf * 128 + tw];
      const float alpha[2] = {al.x, al.y};
      mbar_arrive(p_free + 8 * buf);
#pragma unroll
      for (int c = 0; c < NV; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[c][e] *= alpha[(e >> 1) & 1];
      mbar_wait(k_full + 8 * s, (i / kMlaStages) & 1);
#pragma unroll
      for (int c = 0; c < NV; ++c) pin(acc[c]);
      pin(ph);
      pin(pl);
      wg_fence();
      start_pv_wide<NV, BK>(acc, ph, pl,
                            k_s + s * ND * BK * kRowBytes + v_off);
      wg_wait<0>();
#pragma unroll
      for (int c = 0; c < NV; ++c) pin(acc[c]);
      if (lane == 0) mbar_arrive(k_free + 8 * s);
    }
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");   // l is in sL
  {
    const float2 lf = sL[tw];
    l[0] = lf.x;
    l[1] = lf.y;
  }

  // The block's 64 output rows are staged in shared memory over q and the
  // ring (free now), then written out whole, 16 bytes a lane: unsplit, the
  // output in bf16; a split, acc in f32 to the workspace in the split
  // route's layout (partial (b * K + kh) * splits + sp) with m and l, and
  // no acc for a row without a visible key (paged_combine_kernel reads
  // none of such a row).
  const bool part = splits > 1;
  const int row_bytes = p.Dv * (part ? 4 : 2), stride = row_bytes + 16;
  float* const sRowL = reinterpret_cast<float*>(sA);   // free now
  const size_t pidx = (size_t)blockIdx.z * splits + sp;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    const float inv = 1.f / (l[r] > 0.f ? l[r] : 1.f);
    unsigned char* const dst = base + rr * stride;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = (wg * NV + c) * kBox + 8 * j + cq;
        if (col >= p.Dv) continue;
        const float x0 = acc[c][4 * j + 2 * r], x1 = acc[c][4 * j + 2 * r + 1];
        if (part)
          *reinterpret_cast<float2*>(dst + col * 4) = make_float2(x0, x1);
        else
          *reinterpret_cast<__nv_bfloat162*>(dst + col * 2) =
              __floats2bfloat162_rn(x0 * inv, x1 * inv);
      }
    if (part && wg == 0 && lane % 4 == 0 && rr < R) {
      float* const w_ml = ws + (size_t)p.B * p.K * splits * Rt * p.Dv +
                          pidx * 2 * Rt;
      w_ml[r0 + rr] = m[r];
      w_ml[Rt + r0 + rr] = l[r];
      sRowL[rr] = l[r];
    }
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  const int cpr = row_bytes / 16;
  for (int idx = threadIdx.x; idx < R * cpr; idx += 256) {
    const int rr = idx / cpr, c = idx % cpr, orow = r0 + rr;
    unsigned char* dst;
    if (part) {
      if (!(sRowL[rr] > 0.f)) continue;
      dst = reinterpret_cast<unsigned char*>(ws + (pidx * Rt + orow) * p.Dv);
    } else {
      dst = static_cast<unsigned char*>(p.out) +
            ((size_t)(b * p.S + orow / G) * p.H + kh * G + orow % G) *
                row_bytes;
    }
    *reinterpret_cast<uint4*>(dst + c * 16) =
        *reinterpret_cast<const uint4*>(base + rr * stride + c * 16);
  }
}

template <int NDK>
cudaError_t launch_mla(const Params& p, float* ws, int splits, int per,
                       cudaStream_t stream) {
  const size_t smem = mla_smem_bytes(NDK, p.npps, p.ps);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // the ckv and kr pools as (D, K, P*ps) tensors, in boxes of 64 columns x
  // 1 head x min(ps, BK) rows
  CUtensorMap tk{}, tk2{}, tq{}, tq2{};
  const cuuint64_t rows = (cuuint64_t)p.P * p.ps;
  const cuuint32_t box_rows = (cuuint32_t)(p.ps < kMlaBK ? p.ps : kMlaBK);
  if (!tensor_map_3d(&tk, p.k, {(cuuint64_t)p.Dk, (cuuint64_t)p.K, rows},
                     {(cuuint64_t)p.Dk * 2, (cuuint64_t)p.K * p.Dk * 2},
                     {kBox, 1, box_rows}) ||
      !tensor_map_3d(&tk2, p.k2, {(cuuint64_t)p.Dk2, (cuuint64_t)p.K, rows},
                     {(cuuint64_t)p.Dk2 * 2, (cuuint64_t)p.K * p.Dk2 * 2},
                     {kBox, 1, box_rows}))
    return cudaErrorInvalidValue;
  // q and q2 as (D, H, B*S) tensors in boxes of 64 columns x 64 heads, where
  // a block's 64 rows are 64 heads of one query (G a multiple of 64)
  const cuuint64_t qrows = (cuuint64_t)p.B * p.S;
  if ((p.H / p.K) % kRows == 0 &&
      (!tensor_map_3d(&tq, p.q, {(cuuint64_t)p.Dk, (cuuint64_t)p.H, qrows},
                      {(cuuint64_t)p.Dk * 2, (cuuint64_t)p.H * p.Dk * 2},
                      {kBox, kRows, 1}) ||
       !tensor_map_3d(&tq2, p.q2, {(cuuint64_t)p.Dk2, (cuuint64_t)p.H, qrows},
                      {(cuuint64_t)p.Dk2 * 2, (cuuint64_t)p.H * p.Dk2 * 2},
                      {kBox, kRows, 1})))
    return cudaErrorInvalidValue;
  auto kern = paged_mla_kernel<NDK>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int Rt = p.S * (p.H / p.K);
  const dim3 grid((Rt + kRows - 1) / kRows, splits, p.B * p.K);
  kern<<<grid, kMlaThreads, smem, stream>>>(tk, tk2, tq, tq2, p, ws, splits,
                                            per);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const size_t wbytes = (size_t)splits * 4;
  if (wbytes > kMaxSmem) return cudaErrorInvalidValue;
  if (wbytes > 48 * 1024) {
    e = cudaFuncSetAttribute(paged_combine_kernel<__nv_bfloat16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)wbytes);
    if (e != cudaSuccess) return e;
  }
  paged_combine_kernel<__nv_bfloat16>
      <<<dim3(Rt, p.K, p.B), kThreads, wbytes, stream>>>(p, ws, splits);
  return cudaGetLastError();
}

using MlaLaunch = cudaError_t (*)(const Params&, float*, int, int,
                                  cudaStream_t);
constexpr MlaLaunch kMlaLaunch[8] = {launch_mla<1>, launch_mla<2>,
                                     launch_mla<3>, launch_mla<4>,
                                     launch_mla<5>, launch_mla<6>,
                                     launch_mla<7>, launch_mla<8>};

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller checks shapes, types and contiguity; tables must hold -1 or a page
// id below P (an id out of range is skipped like a dead page).
extern "C" int paged_attention_launch(
    const void* q, const void* k, const void* v, const int* kpos,
    const int* tables, const int* q_pos, const void* q2, const void* k2,
    void* out, int B, int S, int H, int K, int Dk, int Dk2, int Dv, int P,
    int ps, int npps, float scale, int causal, int has_window, int window,
    int has_cap, float cap, int is_bf16, void* stream) {
  if (B == 0 || S == 0) return (int)cudaSuccess;
  const int n_rows = S * (H / K);
  const size_t fixed = smem_floats(0, ps, Dk, Dk2, Dv) * sizeof(float);
  const size_t per_row =
      smem_floats(1, ps, Dk, Dk2, Dv) * sizeof(float) - fixed;
  if (fixed + per_row > kMaxSmem) return (int)cudaErrorInvalidValue;
  int rows = n_rows < kMaxRows ? n_rows : kMaxRows;
  const int fit = (int)((kMaxSmem - fixed) / per_row);
  if (rows > fit) rows = fit;
  Params p{q, k, v, kpos, tables, q_pos, q2, k2, out,
           B, S, H, K, Dk, Dk2, Dv, P, ps, npps, rows,
           scale, causal, has_window, window, has_cap, cap};
  const dim3 grid((n_rows + rows - 1) / rows, K, B);
  const size_t smem = smem_floats(rows, ps, Dk, Dk2, Dv) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(p, grid, smem, st)
                       : launch<float>(p, grid, smem, st));
}

// The split route: paged_split_kernel over `splits` ranges of `per` table
// entries, then paged_combine_kernel, on `stream`. `ws` holds
// B*K*splits*S*(H/K)*(Dv + 2) floats. Dk, Dk2 and Dv times the element size
// are multiples of 16 bytes, and every pointer is 16-byte aligned.
extern "C" int paged_attention_split_launch(
    const void* q, const void* k, const void* v, const int* kpos,
    const int* tables, const int* q_pos, const void* q2, const void* k2,
    void* out, void* ws, int B, int S, int H, int K, int Dk, int Dk2, int Dv,
    int P, int ps, int npps, int splits, int per, float scale, int causal,
    int has_window, int window, int has_cap, float cap, int is_bf16,
    void* stream) {
  if (B == 0 || S == 0) return (int)cudaSuccess;
  const int vn = is_bf16 ? 8 : 4;
  if (Dk % vn || Dk2 % vn || Dv % vn || splits < 1 || per < 1)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, kpos, tables, q_pos, q2, k2, out,
                 B, S, H, K, Dk, Dk2, Dv, P, ps, npps, 0,
                 scale, causal, has_window, window, has_cap, cap,
                 has_cap ? (float)(1.0 / cap) : 0.f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* const w = static_cast<float*>(ws);
  return (int)(is_bf16 ? launch_split<__nv_bfloat16>(p, w, splits, per, st)
                       : launch_split<float>(p, w, splits, per, st));
}

// The tile route (bf16, no q2): Dk and Dv multiples of 8 in [8, 256], ps a
// power of two that divides 64, every pointer 16-byte aligned.
extern "C" int paged_attention_tile_launch(
    const void* q, const void* k, const void* v, const int* kpos,
    const int* tables, const int* q_pos, void* out, int B, int S, int H,
    int K, int Dk, int Dv, int P, int ps, int npps, float scale, int causal,
    int has_window, int window, int has_cap, float cap, void* stream) {
  if (B == 0 || S == 0) return (int)cudaSuccess;
  if (Dk < 8 || Dk > 256 || Dk % 8 || Dv < 8 || Dv > 256 || Dv % 8 ||
      ps < 1 || 64 % ps)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, kpos, tables, q_pos, nullptr, nullptr, out,
                 B, S, H, K, Dk, 0, Dv, P, ps, npps, 0,
                 scale, causal, has_window, window, has_cap, cap};
  return (int)dispatch_tile(p, static_cast<cudaStream_t>(stream));
}

// The mla route (bf16; v the same tensor as k): Dk a multiple of 64 in [64,
// 512], Dk2 a multiple of 8 in [8, 64], ps a power of two >= 8, every
// pointer 16-byte aligned. `splits` ranges of `per` 32-key tiles a slot;
// with splits > 1, `ws` holds B*K*splits*S*(H/K)*(Dk + 2) floats and
// paged_combine_kernel writes the output.
extern "C" int paged_attention_mla_launch(
    const void* q, const void* kv, const int* kpos, const int* tables,
    const int* q_pos, const void* q2, const void* k2, void* out, void* ws,
    int B, int S, int H, int K, int Dk, int Dk2, int P, int ps, int npps,
    int splits, int per, float scale, int causal, int has_window, int window,
    int has_cap, float cap, void* stream) {
  if (B == 0 || S == 0) return (int)cudaSuccess;
  if (Dk < 64 || Dk > 512 || Dk % 64 || Dk2 < 8 || Dk2 > 64 || Dk2 % 8 ||
      ps < 8 || (ps & (ps - 1)) || splits < 1 || per < 1 || !q2 || !k2 ||
      (splits > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  const Params p{q, kv, kv, kpos, tables, q_pos, q2, k2, out,
                 B, S, H, K, Dk, Dk2, Dk, P, ps, npps, 0,
                 scale, causal, has_window, window, has_cap, cap};
  return (int)kMlaLaunch[Dk / 64 - 1](p, static_cast<float*>(ws), splits,
                                       per, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one block of each route, in bytes, and the most
// a block may take: the wrapper chooses a route only where its block fits.
extern "C" long long paged_attention_split_smem_bytes(int R, int ps, int Dt,
                                                      int Dv, int elem,
                                                      int per) {
  return (long long)split_layout(R, ps, Dt, Dv, elem, per).total;
}
extern "C" long long paged_attention_tile_smem_bytes(int Dk, int Dv,
                                                     int npps, int ps) {
  return (long long)tile_smem_bytes(boxes(Dk), boxes(Dv), npps, ps);
}
extern "C" long long paged_attention_mla_smem_bytes(int Dk, int npps,
                                                    int ps) {
  return (long long)mla_smem_bytes(boxes(Dk), npps, ps);
}
extern "C" long long paged_attention_max_smem_bytes() {
  return (long long)kMaxSmem;
}
