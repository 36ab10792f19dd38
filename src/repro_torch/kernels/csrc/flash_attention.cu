// Flash attention for Hopper (sm_90a): blocked online-softmax attention over
// implicit positions 0..S-1.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (called through flash_attention, and through repro.kernels.ops.attention).
// Same function: q (B,H,Sq,D) against k (B,K,Sk,D) and v (B,K,Sk,Dv), query
// head h reading kv head h / (H/K); scores are q.k in f32 times `scale`
// (never folded into q), then `cap * tanh(s / cap)` with a softcap; a key is
// visible when k_pos < Sk, k_pos <= q_pos (causal) and q_pos - k_pos < window,
// positions counted from 0 for q and for k alike (top-left aligned, also
// when Sq != Sk). Masked scores go to -1e30 before the running max, p is
// re-masked to 0 after the exp, and the output is acc / l with l == 0 read
// as 1, so a row that sees no key comes out as exact zeros. Out in q's type.
//
// What bounds it on this card: operations. The function costs 2*(D+Dv)
// flops per visible (q, k) pair and head for 2*(D+Dv)/S bytes of its k and v
// rows, hundreds of flops per byte at prefill lengths, above the ~295
// flop/byte where an H100's bf16 tensor cores and its memory take the same
// time (qwen3-14b at 4,096 tokens: 1.72e11 flops against 0.1 GB). So the
// bf16 kernel runs both products on the tensor cores (wgmma, bf16 in, f32
// out) and keeps m, l, the scores and the output accumulator in registers.
//
// Rounding. The reference keeps p in f32 and widens v before p @ v. A
// tensor-core product takes p in bf16, and one bf16 rounding of p (2^-9
// relative) is already as large as the one rounding of the output that the
// result may carry. So p is split in two bf16 terms, P_hi = bf16(p) and
// P_lo = bf16(p - P_hi), and acc += P_hi @ v + P_lo @ v in one f32
// accumulator: what remains of p's rounding is ~2^-18 p. That is three
// products where the function needs two: 1.5x its flops at D = Dv, all on
// the tensor cores. q @ k needs no such care: a bf16 x bf16 product is exact
// in f32. l is summed from the f32 p, never from its parts.
//
// The bf16 kernel. One block of 160 threads per (64-row query tile, head h,
// batch row b): warps 0-3 are one consumer warpgroup that owns the 64 rows;
// warp 4 is the producer, one lane of which starts every TMA load. Tiles
// arrive by TMA in boxes of 64 columns (128 bytes) with the 128-byte swizzle
// that the wgmma descriptors name; rows past Sq or Sk and the columns past D
// or Dv are TMA's out-of-bounds zero fill, so D pads to a multiple of 64 in
// shared memory and never in device memory. q is loaded once; k and v tiles
// stream through rings of 2 stages, k and v each with a `full` mbarrier (the
// TMA bytes landed) and a `free` one (the 4 consumer warps are done with
// it), so a k tile is reloaded as soon as its scores are in. Per key tile
// of BK keys:
//   1. S = q @ k^T: wgmma m64nBKk16, q and k from shared memory, K-major,
//      4*ceil(D/64) steps; scale, softcap and the mask on the f32 fragment
//      in registers (the mask only on tiles that the edges cross);
//   2. online softmax on the fragment: each thread holds 2 rows, and a row's
//      max and sum are reduced by shuffles among the 4 threads that share it;
//   3. acc = acc * alpha + P_hi @ v + P_lo @ v: wgmma m64n64k16 per 64
//      columns of Dv, P from registers (the f32 fragment converts pair by
//      pair into the bf16 A fragment), v from shared memory, MN-major
//      (the transpose bit for 16-bit types).
// The products of consecutive tiles overlap: tile i+1's q @ k^T starts
// with tile i's P @ v, and tile i+1's softmax runs on the CUDA cores while
// that P @ v is still on the tensor cores; acc is rescaled once it is in.
// Key tiles that the causal mask or the window hides completely are never
// loaded; query tiles run last-first, so the longest causal rows start first.
// exp is ex2.approx.ftz (2 ulp; a p below 2^-126 flushes to 0) with log2(e)
// applied in f32; tanhf stays the accurate one: tanh.approx's ~2^-11 times a
// cap of 50 would move a score by ~0.02.
//
// Tiles: BK = 64 keys, or 32 where Dv > 128 (the accumulator then takes 96
// or 128 registers a thread) or where a 64-key ring would keep a second
// block off the SM. Registers a thread: the 64 x 64*ceil(Dv/64) f32
// accumulator (32-128), the S fragment (BK/2), P_hi and P_lo (BK/4 each),
// within 200 (__maxnreg__), so that two blocks of 160 threads share an SM.
// Shared memory: q 64 x 64*ceil(D/64) bf16 + 2 stages x BK x
// 64*(ceil(D/64) + ceil(Dv/64)) bf16, 72 bytes of barriers and 1 KB to
// align the swizzle: 83,016 bytes at D = Dv = 128 (BK 64), 99,400 at
// D = Dv = 256 (BK 32); two blocks an SM.
//
// The f32 path keeps the CUDA-core design (flash_attention_f32_kernel): an
// f32 q.k on bf16 tensor cores would lose the reference's f32 bound of 2e-5,
// and TF32 keeps about three digits. One 256-thread block per query tile
// walks 64-key tiles, 4 rows x 4 keys of scores a thread, f32 FMAs.
//
// Left for later:
//   * two consumer warpgroups a block in ping-pong, so one's softmax hides
//     under the other's products;
//   * one block serving the G query heads of a kv head (k and v are re-read
//     per query head now; L2 catches most of it);
//   * split-K over the key axis where B*H*ceil(Sq/64) blocks do not fill 132
//     SMs (not the case at the shapes the configs use);
//   * fp8 products, with scales beside the data.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kMaxDim = 256;            // D and Dv
constexpr size_t kMaxSmem = 232448;     // 227 KB: a block's opt-in limit
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;   // (B, H, Sq, D)
  const void* k;   // (B, K, Sk, D)
  const void* v;   // (B, K, Sk, Dv)
  void* o;         // (B, H, Sq, Dv)
  int B, H, K, Sq, Sk, D, Dv;
  float scale;
  int causal, has_window, window, has_cap;
  float cap;
};

// The key tiles [k_begin, k_end) that the query rows [q0, q0 + rows) can
// see, k_begin rounded down to a tile of bk keys.
struct KeyRange {
  int begin, end;
};
__device__ __forceinline__ KeyRange key_range(const Params& p, int q0,
                                              int rows, int bk) {
  const int q_last = min(q0 + rows, p.Sq) - 1;
  int k_begin = 0, k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q_last + 1);
  if (p.has_window) k_begin = max(0, q0 - p.window + 1);
  return {k_begin / bk * bk, k_end};
}

// ---------------------------------------------------------------------------
// float32: both products on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;           // 16 x 16
constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per tile
constexpr int kPad = 4;                 // q and k rows: D + 4 elements
constexpr int kLdp = kBK + 4;           // score tile row stride (floats)

// Copy `valid` rows of width W (a multiple of 4) from src (row stride W) to
// dst (row stride ld), zero-filling rows [valid, rows).
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      int W, int rows, int valid) {
  const int per_row = W / 4;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) x = *reinterpret_cast<const float4*>(src + (size_t)r * W + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = x;
  }
}

// Dynamic shared memory of one block, in bytes: q, scores, k, v.
inline size_t f32_smem_bytes(int D, int np) {
  return ((size_t)kBQ * (D + kPad) + (size_t)kBQ * kLdp +
          (size_t)kBK * (D + kPad) + (size_t)kBK * 32 * np) * 4;
}

// NP: pairs of output columns per thread (Dv <= 32 * NP).
template <int NP>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];
  const int D = p.D, Dv = p.Dv, ld = D + kPad, ldv = 32 * NP;
  float* const q_s = reinterpret_cast<float*>(smem4);    // kBQ x ld
  float* const p_s = q_s + kBQ * ld;                      // kBQ x kLdp
  float* const k_s = p_s + kBQ * kLdp;                    // kBK x ld
  float* const v_s = k_s + kBK * ld;                      // kBK x ldv

  const int nq = (p.Sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* const Q = static_cast<const float*>(p.q) +
                         ((size_t)b * p.H + h) * p.Sq * D;
  const float* const Kg = static_cast<const float*>(p.k) +
                          ((size_t)b * p.K + kh) * p.Sk * D;
  const float* const Vg = static_cast<const float*>(p.v) +
                          ((size_t)b * p.K + kh) * p.Sk * Dv;
  float* const O = static_cast<float*>(p.o) + ((size_t)b * p.H + h) * p.Sq * Dv;
  const KeyRange kr = key_range(p, q0, kBQ, kBK);

  // q once; v's pad columns [Dv, ldv) stay zero throughout
  stage(q_s, ld, Q + (size_t)q0 * D, D, kBQ, min(kBQ, p.Sq - q0));
  for (int i = tid; i < kBK * (ldv - Dv); i += kThreads) {
    const int r = i / (ldv - Dv), c = Dv + i % (ldv - Dv);
    v_s[r * ldv + c] = 0.f;
  }

  float m[4], l[4], acc[4][2 * NP];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 2 * NP; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = kr.begin; k0 < kr.end; k0 += kBK) {
    __syncthreads();                    // the last tile's k, v, p are used
    const int valid = min(kBK, p.Sk - k0);
    stage(k_s, ld, Kg + (size_t)k0 * D, D, kBK, valid);
    stage(v_s, ldv, Vg + (size_t)k0 * Dv, Dv, kBK, valid);
    __syncthreads();

    // s = q . k on a 4 x 4 tile: rows ty*4+i, keys tx+16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (ty * 4 + i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // scale, softcap, mask; online softmax across the row's 16 threads
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      unsigned vis = 0;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (p.has_cap) x = p.cap * tanhf(x / p.cap);
        bool ok = kp < p.Sk;
        if (p.causal) ok = ok && kp <= qp;
        if (p.has_window) ok = ok && qp - kp < p.window;
        s[i][j] = ok ? x : kNegInf;
        vis |= (unsigned)ok << j;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // exp(-1e30 - m_new) is 1 where the row has seen no key yet:
        // re-mask after the exp
        const float e = (vis >> j & 1u) ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty * 4 + i) * kLdp + tx + 16 * j] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 2 * NP; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();                    // the score tile is complete

    // acc += p @ v: rows ty*4+i, columns 2*tx + 32*t + {0, 1}
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] =
            *reinterpret_cast<const float4*>(p_s + (ty * 4 + i) * kLdp + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* const vrow = v_s + (j + jj) * ldv + 2 * tx;
#pragma unroll
        for (int t = 0; t < NP; ++t) {
          const float2 x = *reinterpret_cast<const float2*>(vrow + 32 * t);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float w = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y
                          : jj == 2 ? pv[i].z : pv[i].w;
            acc[i][2 * t] = fmaf(w, x.x, acc[i][2 * t]);
            acc[i][2 * t + 1] = fmaf(w, x.y, acc[i][2 * t + 1]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty * 4 + i;
    if (q >= p.Sq) continue;
    const float den = l[i] > 0.f ? l[i] : 1.f;
#pragma unroll
    for (int t = 0; t < NP; ++t) {
      const int c = 2 * tx + 32 * t;
      if (c < Dv)
        *reinterpret_cast<float2*>(O + (size_t)q * Dv + c) =
            make_float2(acc[i][2 * t] / den, acc[i][2 * t + 1] / den);
    }
  }
}

template <int NP>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  auto kern = flash_attention_f32_kernel<NP>;
  const size_t smem = f32_smem_bytes(p.D, NP);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, p.B);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

int np_of(int Dv) {
  return Dv <= 32 ? 1 : Dv <= 64 ? 2 : Dv <= 128 ? 4 : Dv <= 160 ? 5 : 8;
}

cudaError_t dispatch_f32(const Params& p, cudaStream_t stream) {
  switch (np_of(p.Dv)) {
    case 1: return launch_f32<1>(p, stream);
    case 2: return launch_f32<2>(p, stream);
    case 4: return launch_f32<4>(p, stream);
    case 5: return launch_f32<5>(p, stream);
    default: return launch_f32<8>(p, stream);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: both products on the tensor cores (wgmma), tiles by TMA
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128 + 32;    // the warpgroup + one producer warp
constexpr int kStages = 2;              // k/v ring
constexpr int kBarBytes = 8 * (1 + 4 * kStages);
constexpr size_t kTwoBlocks = kMaxSmem / 2 - 1024;  // both fit on one SM
constexpr int kMaxRegs = 200;           // two blocks of 160 threads an SM
constexpr float kLog2e = 1.4426950408889634f;

inline int boxes(int d) { return (d + kBox - 1) / kBox; }

// Dynamic shared memory of one block with ndk and ndv boxes of D and Dv:
// q, the k ring, the v ring, barriers, and 1 KB to align the swizzled tiles
// to 1,024 bytes.
constexpr size_t tc_smem_bytes(int ndk, int ndv, int bk) {
  return 1024 + (size_t)kRows * ndk * kRowBytes +
         (size_t)kStages * bk * (ndk + ndv) * kRowBytes + kBarBytes;
}
// Keys a tile: 64 where the accumulator is at most 64 x 128 and two blocks'
// shared memory fits on one SM; else 32.
constexpr int tc_bk(int ndk, int ndv) {
  return ndv <= 2 && tc_smem_bytes(ndk, ndv, 64) <= kTwoBlocks ? 64 : 32;
}

// Scale, softcap and mask on the S fragment of keys [k0, k0 + BK), then the
// online softmax: p (f32) replaces s, m and l move on, alpha is what the
// accumulator is to be scaled by. The softcap and the mask sit behind
// branches around whole loops, taken alike by every thread: per element
// they would run predicated on every tile. The 4 threads of a row reduce its
// max by shuffles.
template <int BK>
__device__ __forceinline__ void softmax(float (&sc)[BK / 2], const Params& p,
                                        int q0, int k0, const int (&qr)[2],
                                        int cq, float (&m)[2], float (&l)[2],
                                        float (&alpha)[2]) {
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) sc[e] *= p.scale;
  if (p.has_cap) {
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sc[e] = p.cap * tanhf(sc[e] / p.cap);
  }
  uint32_t vis = ~0u;                   // the keys this thread's rows see
  if (k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > q0) ||
      (p.has_window && q0 + kRows - 1 - k0 >= p.window)) {
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int kp = k0 + 8 * (e / 4) + cq + (e & 1), qp = qr[(e >> 1) & 1];
      bool ok = kp < p.Sk;
      if (p.causal) ok = ok && kp <= qp;
      if (p.has_window) ok = ok && qp - kp < p.window;
      if (!ok) {
        sc[e] = kNegInf;
        vis &= ~(1u << e);
      }
    }
  }
  float mx[2] = {kNegInf, kNegInf}, mb[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
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

// NDK, NDV: 64-column boxes of D and Dv (the accumulator is 64 x 64*NDV
// f32); BK keys a tile. The m64nNk16 fragments: thread t of
// the warpgroup holds rows 16*(t/32) + (t%32)/4 and that + 8; element
// 4*j + e of an N-wide fragment is column 8*j + 2*(t%4) + (e&1) of the
// first row (e < 2) or the second.
template <int NDK, int NDV, int BK = tc_bk(NDK, NDV)>
__global__ void __maxnreg__(kMaxRegs)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t q_s = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t k_s = q_s + kRows * NDK * kRowBytes;
  const uint32_t v_s = k_s + kStages * BK * NDK * kRowBytes;
  // barriers: q landed; per stage, k landed / k used, v landed / v used
  const uint32_t q_full = v_s + kStages * BK * NDV * kRowBytes;
  const uint32_t k_full = q_full + 8, k_free = k_full + 8 * kStages;
  const uint32_t v_full = k_free + 8 * kStages, v_free = v_full + 8 * kStages;

  const int nq = (p.Sq + kRows - 1) / kRows;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const KeyRange kr = key_range(p, q0, kRows, BK);
  const int n_tiles = kr.end > kr.begin ? (kr.end - kr.begin + BK - 1) / BK : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(k_free + 8 * s, 4);     // one arrival per consumer warp
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_free + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {                      // the producer
    if (lane == 0) {
      const int qz = b * p.H + h, kz = b * p.K + kh;
      mbar_expect_tx(q_full, kRows * NDK * kRowBytes);
      for (int c = 0; c < NDK; ++c)
        tma_load(q_s + c * kRows * kRowBytes, &tq, c * kBox, q0, qz, q_full);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages, k0 = kr.begin + i * BK;
        const uint32_t parity = (i / kStages - 1) & 1;
        if (i >= kStages) mbar_wait(k_free + 8 * s, parity);
        mbar_expect_tx(k_full + 8 * s, BK * NDK * kRowBytes);
        for (int c = 0; c < NDK; ++c)
          tma_load(k_s + (s * NDK + c) * BK * kRowBytes, &tk, c * kBox, k0,
                   kz, k_full + 8 * s);
        if (i >= kStages) mbar_wait(v_free + 8 * s, parity);
        mbar_expect_tx(v_full + 8 * s, BK * NDV * kRowBytes);
        for (int c = 0; c < NDV; ++c)
          tma_load(v_s + (s * NDV + c) * BK * kRowBytes, &tv, c * kBox, k0,
                   kz, v_full + 8 * s);
      }
    }
    return;
  }

  // The consumer warpgroup. Tile i + 1's q @ k^T runs on the tensor cores
  // while tile i's P @ v does, and its softmax while P @ v still runs.
  // Every register a product reads or writes is set before the fence that
  // opens its group: one set between fence and commit would serialize them.
  const int row = warp * 16 + lane / 4;            // and row + 8
  const int qr[2] = {q0 + row, q0 + row + 8};
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
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sc[e] = 0.f;
    pin(sc);
    wg_fence();
    start_qk<NDK, BK>(sc, q_s, k_s);
    wg_wait<0>();
    pin(sc);
    if (lane == 0) mbar_arrive(k_free);
    softmax<BK>(sc, p, q0, kr.begin, qr, cq, m, l, alpha);
    split<BK>(sc, ph, pl);              // acc is zero: alpha needs no use
  }
  for (int i = 0; i + 1 < n_tiles; ++i) {
    const int s = i % kStages, t = (i + 1) % kStages;
    mbar_wait(k_full + 8 * t, ((i + 1) / kStages) & 1);
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sc[e] = 0.f;
    mbar_wait(v_full + 8 * s, (i / kStages) & 1);
    pin(sc);
#pragma unroll
    for (int c = 0; c < NDV; ++c) pin(acc[c]);
    pin(ph);
    pin(pl);
    wg_fence();
    start_qk<NDK, BK>(sc, q_s, k_s + t * NDK * BK * kRowBytes);
    start_pv<NDV, BK>(acc, ph, pl, v_s + s * NDV * BK * kRowBytes);
    wg_wait<1>();                       // tile i + 1's scores are in
    pin(sc);
    if (lane == 0) mbar_arrive(k_free + 8 * t);
    softmax<BK>(sc, p, q0, kr.begin + (i + 1) * BK, qr, cq, m, l, alpha);
    wg_wait<0>();                       // tile i's P @ v is in
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
  if (n_tiles > 0) {                    // the last tile's P @ v
    const int i = n_tiles - 1;
    mbar_wait(v_full + 8 * (i % kStages), (i / kStages) & 1);
#pragma unroll
    for (int c = 0; c < NDV; ++c) pin(acc[c]);
    pin(ph);
    pin(pl);
    wg_fence();
    start_pv<NDV, BK>(acc, ph, pl, v_s + (i % kStages) * NDV * BK * kRowBytes);
    wg_wait<0>();
#pragma unroll
    for (int c = 0; c < NDV; ++c) pin(acc[c]);
  }

  __nv_bfloat16* const O = static_cast<__nv_bfloat16*>(p.o) +
                           ((size_t)b * p.H + h) * p.Sq * p.Dv;
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    den[r] = l[r] > 0.f ? l[r] : 1.f;
  }
#pragma unroll
  for (int c = 0; c < NDV; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int col = c * kBox + 8 * j + cq;
        if (qr[r] < p.Sq && col < p.Dv)
          *reinterpret_cast<__nv_bfloat162*>(O + (size_t)qr[r] * p.Dv + col) =
              __floats2bfloat162_rn(acc[c][4 * j + 2 * r] / den[r],
                                    acc[c][4 * j + 2 * r + 1] / den[r]);
      }
}

// A (depth, rows, cols) bf16 tensor, read in boxes of rows x 64 columns with
// the 128-byte swizzle; out-of-bounds elements read as zeros.
bool tensor_map(CUtensorMap* map, const void* ptr, int cols, int rows,
                int depth, int box_rows) {
  return tensor_map_3d(
      map, ptr, {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)depth},
      {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2},
      {kBox, (cuuint32_t)box_rows, 1});
}

template <int NDK, int NDV>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  constexpr int BK = tc_bk(NDK, NDV);
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, p.q, p.D, p.Sq, p.B * p.H, kRows) ||
      !tensor_map(&tk, p.k, p.D, p.Sk, p.B * p.K, BK) ||
      !tensor_map(&tv, p.v, p.Dv, p.Sk, p.B * p.K, BK))
    return cudaErrorInvalidValue;
  auto kern = flash_attention_bf16_kernel<NDK, NDV>;
  constexpr size_t smem = tc_smem_bytes(NDK, NDV, BK);
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Sq + kRows - 1) / kRows, p.H, p.B);
  kern<<<grid, kTcThreads, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const Params&, cudaStream_t);
template <int NDK>
constexpr Launch kLaunchRow[4] = {launch_bf16<NDK, 1>, launch_bf16<NDK, 2>,
                                  launch_bf16<NDK, 3>, launch_bf16<NDK, 4>};

cudaError_t dispatch_bf16(const Params& p, cudaStream_t stream) {
  static const Launch* const rows[4] = {kLaunchRow<1>, kLaunchRow<2>,
                                        kLaunchRow<3>, kLaunchRow<4>};
  return rows[boxes(p.D) - 1][boxes(p.Dv) - 1](p, stream);
}

}  // namespace

// Dynamic shared memory one block takes, in bytes.
extern "C" long long flash_attention_smem_bytes(int D, int Dv, int bf16) {
  return bf16 ? (long long)tc_smem_bytes(
                    boxes(D), boxes(Dv), tc_bk(boxes(D), boxes(Dv)))
              : (long long)f32_smem_bytes(D, np_of(Dv));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller checks devices, types and contiguity; q, k, v and o share one type
// (bf16 when `bf16`, else f32), start on 16-byte boundaries, and are
// contiguous in the shapes above. Takes H % K == 0 and D, Dv multiples of 8
// in [8, 256]. `window` is clamped by the caller to [-Sk, Sq], where it
// means the same as any larger or smaller value.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int K, int Sq, int Sk, int D, int Dv,
                                      float scale, int causal, int has_window,
                                      int window, int has_cap, float cap,
                                      int bf16, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return (int)cudaSuccess;
  if (K < 1 || H % K || D < 8 || D > kMaxDim || D % 8 || Dv < 8 ||
      Dv > kMaxDim || Dv % 8)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, B, H, K, Sq, Sk, D, Dv, scale,
                 causal, has_window, window, has_cap, cap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16) return (int)dispatch_f32(p, st);
  if (Sk == 0)                          // no key: every row is zeros
    return (int)cudaMemsetAsync(o, 0, (size_t)B * H * Sq * Dv * 2, st);
  return (int)dispatch_bf16(p, st);
}
