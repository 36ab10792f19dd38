// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::_kernel (called
// through ssd_scan), and computes what the model's XLA path
// src/repro/models/ssm.py::ssd_chunked computes. Per chunk of Q time steps
// of one (batch row b, head h), with cum = cumsum(dt * A) over the chunk:
//   intra-chunk dual  y[q]  = sum_{p<=q} (C_q . B_p) exp(cum_q - cum_p) dt_p x_p
//   state read        y[q] += exp(cum_q) (C_q . h[v, :])      (h at chunk start)
//   state update      h      = exp(cum_last) h + sum_p x_p (B_p exp(cum_last - cum_p) dt_p)
// The (P x N) f32 state is carried from chunk to chunk on chip; the final
// one is written out when asked for (the model's prefill keeps it as its
// cache).
//
// What bounds it on this card: at the serving shapes (P = 64, N = 128,
// Q = 256, bf16 in, f32 out) the four products do ~290 flops per byte the
// scan must move, right at the ~295 flop/byte where an H100's bf16 tensor
// cores and its memory take the same time. Two routes, chosen by shape in
// kernels/ssd_scan.py::_plan:
//
// tc (bf16 x/B/C, P = 64, N = 64 or 128, any chunk): ssd_scan_tc_kernel,
// the four products on the tensor cores (wgmma, bf16 operands, f32 sums).
//   * Rounding. C.B^T is exact (bf16 operands, f32 sums). The other three
//     products take an f32 operand -- the scores (C.B^T exp(..) dt), the
//     weighted inputs x_p w_p of the state update, the carried state of the
//     state read -- as two bf16 terms, hi + lo: one bf16 rounding of any of
//     them alone costs ~1e-3 relative error in y or h at the serving shape,
//     the two terms ~1e-5 (tests/test_torch_ssd.py emulates both).
//   * One block serves G heads of one batch row (B and C are shared by all
//     heads): each C.B^T tile is computed once, and each head's decay and dt
//     are applied to it in registers; B and C are loaded once for G heads.
//     R blocks may split one chunk's 64-row query tiles between them (each
//     carries the state itself), so that a small batch still fills the card.
//     G and R come from shapes and the SM count alone (_plan).
//   * One consumer warpgroup and one producer warp: the producer's lane 0
//     keeps TMA loads of C (per query tile) and of B and x (per key tile,
//     two stages) in flight while the warpgroup multiplies.
//   * Per query tile: y = exp(cum_q) (C . h_hi^T + C . h_lo^T), then per key
//     tile at or before it S = C . B^T, and per head the scores
//     S exp(cum_q - cum_p) dt_p, SELECTED (not multiplied) to 0 for q < p,
//     where the exp overflows; off the diagonal, exp(cum_q - cum_p) is the
//     product exp(cum_q - m) exp(m - cum_p) about m, the least cum of the
//     key tile -- both factors <= 1 wherever dt A <= 0 (the model's: A < 0,
//     dt a softplus) -- so a thread takes 2 exps a tile, not 32; then
//     y += scores_hi @ x + scores_lo @ x. Head g + 1's scores are made while
//     head g's product runs, and C . B^T of the next key tile is issued
//     behind them. No thread-dependent branch and no barrier wait lies
//     between a product's issue and its wait, which would make ptxas
//     serialize the products (it says so: C7518 / C7520).
//   * State update, after every state read of the chunk: per head and key
//     tile, A = (x w)^T by ldmatrix.trans from the x tile (no transposes
//     through shared memory), h += A_hi @ B + A_lo @ B in registers. The
//     f32 state lies in shared memory between chunks as three bf16 terms
//     (hi + lo + lo2, 24 bits: the f32 value to within 2^-24), of which the
//     state read takes two; the final state is written from the f32
//     registers.
//
// simt (f32 inputs and every other shape): ssd_scan_simt_kernel, the first
// design, all products in f32 on the CUDA cores (67 TFLOP/s, not 989). One
// thread block (256 threads) per (head h, batch row b) walks the chunks in
// order, the state in shared memory for the whole scan. A Q x Q f32 score
// tile at Q = 256 is 256 KB, above the 227 KB a block may hold, so each
// chunk is cut into 64-row query tiles, and each query tile walks the
// 64-key tiles at or before it:
//   1. stage the query tile's C (transposed, f32) and start y from the
//      state read, which every query tile does BEFORE the state changes;
//   2. per key tile: stage B (transposed) and x; scores C.B on a 4 x 4
//      register tile per thread; exp(cum_q - cum_p) dt_p is SELECTED, not
//      multiplied, for q < p, where exp overflows to inf (cum falls along
//      the chunk) and inf * 0 would give NaN; then y += scores @ x;
//   3. the last query tile's key walk covers the whole chunk, so it also
//      accumulates the state update in registers; after a barrier (every
//      state read of the chunk is done) the new state is written.
// Any Q >= 1 works (rows and keys past Q are zero-filled); P <= 64 and
// N <= 128. Shared memory above 48 KB is opted in before the launch.
//
// Left for later PRs: two consumer warpgroups (one's scores made while the
// other's products run), the state update overlapped with the next chunk's
// query tiles, and G > 2 at N = 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;              // query rows and keys per tile
constexpr int kLd = kTile + 4;         // row stride of transposed tiles
constexpr int kMaxP = 64;              // head_dim held by x tiles and state
constexpr int kMaxN = 128;             // d_state
constexpr size_t kMaxSmem = 232448;    // 227 KB: a block's opt-in limit

struct Params {
  const void* x;       // (Bz, S, H, P)
  const float* dt;     // (Bz, S, H)
  const float* A;      // (H,)
  const void* B;       // (Bz, S, N)
  const void* C;       // (Bz, S, N)
  void* y;             // (Bz, S, H, P)
  float* h_final;      // (Bz, H, P, N) or null
  int Bz, S, H, P, N, Q;
};

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

__host__ __device__ inline int qpad_of(int Q) {
  return (Q + kTile - 1) / kTile * kTile;
}

// Shared memory, in floats:
//   ht  N x kMaxP   state, ht[n][v]
//   Ct  N x kLd     C of the query tile, Ct[n][q]
//   Bt  N x kLd     B of the key tile, Bt[n][p]
//   xs  kTile x kMaxP  x of the key tile, xs[p][v]
//   St  kTile x kLd    selected, scaled scores, St[p][q]
//   cum, dts, w  qpad each (zero past Q)
// Every array starts on a 16-byte boundary (float4 reads).
inline size_t smem_floats(int N, int Q) {
  return (size_t)N * kMaxP + 2 * (size_t)N * kLd + kTile * kMaxP +
         kTile * kLd + 3 * (size_t)qpad_of(Q);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
ssd_scan_simt_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int N = p.N, P = p.P, Q = p.Q, H = p.H, S = p.S;
  const int qpad = qpad_of(Q);
  float* const ht = smem;
  float* const Ct = ht + N * kMaxP;
  float* const Bt = Ct + N * kLd;
  float* const xs = Bt + N * kLd;
  float* const St = xs + kTile * kMaxP;
  float* const cum = St + kTile * kLd;
  float* const dts = cum + qpad;
  float* const w = dts + qpad;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;   // 16 x 16 threads, 4 x 4 each
  const float A = p.A[h];
  const TI* const X = static_cast<const TI*>(p.x);
  const TI* const Bg = static_cast<const TI*>(p.B);
  const TI* const Cg = static_cast<const TI*>(p.C);
  TO* const Y = static_cast<TO*>(p.y);
  // state rows this thread updates: n = ty + 16 i for i < n_rows
  const int n_rows = N > ty ? (N - ty + 15) / 16 : 0;

  for (int i = tid; i < N * kMaxP; i += kThreads) ht[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {      // one chunk: steps [t0, t0 + Q)
    __syncthreads();                       // last chunk's state is written
    for (int i = tid; i < qpad; i += kThreads)
      dts[i] = i < Q ? p.dt[((size_t)b * S + t0 + i) * H + h] : 0.f;
    __syncthreads();
    if (tid < 32) {                        // warp 0: inclusive scan of dt*A
      float carry = 0.f;
      for (int base = 0; base < qpad; base += 32) {
        const int i = base + tid;
        float v = i < Q ? dts[i] * A : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (tid >= off) v += u;
        }
        v += carry;
        cum[i] = i < Q ? v : 0.f;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float cum_last = cum[Q - 1];
    for (int i = tid; i < qpad; i += kThreads)
      w[i] = i < Q ? expf(cum_last - cum[i]) * dts[i] : 0.f;

    for (int q0 = 0; q0 < Q; q0 += kTile) {
      const bool last = q0 + kTile >= Q;
      for (int i = tid; i < kTile * N; i += kThreads) {
        const int qq = i / N, n = i % N, q = q0 + qq;
        Ct[n * kLd + qq] =
            q < Q ? ld(Cg, ((size_t)b * S + t0 + q) * N + n) : 0.f;
      }
      __syncthreads();                     // Ct staged (and w, cum ready)

      // 1. state read: acc[q][v] = exp(cum_q) * sum_n C[q][n] h[v][n]
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float4 c4 = ld4(Ct + n * kLd + ty * 4);
        const float4 h4 = ld4(ht + n * kMaxP + tx * 4);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
        const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], hv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(cum[q0 + ty * 4 + i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }

      // the last query tile also carries the state update
      float hacc[8][4];
      if (last) {
        const float dec = expf(cum_last);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            hacc[i][j] =
                i < n_rows ? ht[(ty + 16 * i) * kMaxP + tx * 4 + j] * dec : 0.f;
      }

      for (int p0 = 0; p0 <= q0; p0 += kTile) {
        __syncthreads();                   // Bt, xs and St are free
        for (int i = tid; i < kTile * N; i += kThreads) {
          const int pp = i / N, n = i % N, pk = p0 + pp;
          Bt[n * kLd + pp] =
              pk < Q ? ld(Bg, ((size_t)b * S + t0 + pk) * N + n) : 0.f;
        }
        for (int i = tid; i < kTile * kMaxP; i += kThreads) {
          const int pp = i / kMaxP, v = i % kMaxP, pk = p0 + pp;
          xs[i] = (pk < Q && v < P)
                      ? ld(X, (((size_t)b * S + t0 + pk) * H + h) * P + v)
                      : 0.f;
        }
        __syncthreads();

        // 2. scores, selected and scaled, into St (transposed)
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          const float4 c4 = ld4(Ct + n * kLd + ty * 4);
          const float4 b4 = ld4(Bt + n * kLd + tx * 4);
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int pk = p0 + tx * 4 + j;
          float out[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int q = q0 + ty * 4 + i;
            out[i] = q >= pk ? s[i][j] * expf(cum[q] - cum[pk]) * dts[pk]
                             : 0.f;
          }
          *reinterpret_cast<float4*>(St + (tx * 4 + j) * kLd + ty * 4) =
              make_float4(out[0], out[1], out[2], out[3]);
        }

        // 3. state update: h[v][n] += sum_p B[p][n] w_p x[p][v]
        if (last) {
          for (int pp = 0; pp < kTile; ++pp) {
            const float wp = w[p0 + pp];
            const float4 x4 = ld4(xs + pp * kMaxP + tx * 4);
            const float xv[4] = {x4.x * wp, x4.y * wp, x4.z * wp, x4.w * wp};
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              if (i < n_rows) {
                const float bn = Bt[(ty + 16 * i) * kLd + pp];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  hacc[i][j] = fmaf(bn, xv[j], hacc[i][j]);
              }
            }
          }
        }
        __syncthreads();                   // St complete

        // y += scores @ x
        for (int pp = 0; pp < kTile; ++pp) {
          const float4 s4 = ld4(St + pp * kLd + ty * 4);
          const float4 x4 = ld4(xs + pp * kMaxP + tx * 4);
          const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
          const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(sv[i], xv[j], acc[i][j]);
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + ty * 4 + i;
        if (q >= Q) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int v = tx * 4 + j;
          if (v < P)
            st(Y, (((size_t)b * S + t0 + q) * H + h) * P + v, acc[i][j]);
        }
      }
      if (last) {
        __syncthreads();                   // every state read is done
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (i < n_rows)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              ht[(ty + 16 * i) * kMaxP + tx * 4 + j] = hacc[i][j];
      }
    }
  }

  if (p.h_final != nullptr) {
    __syncthreads();
    for (int i = tid; i < P * N; i += kThreads) {
      const int v = i / N, n = i % N;
      p.h_final[(((size_t)b * H + h) * P + v) * N + n] = ht[n * kMaxP + v];
    }
  }
}

template <typename TI, typename TO>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  auto kern = ssd_scan_simt_kernel<TI, TO>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(p.H, p.Bz), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tc: the products on the tensor cores (wgmma), tiles by TMA
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int kThreads = 128 + 32;     // the warpgroup + one producer warp
constexpr int kT = 64;                 // query rows / keys of a tile
constexpr int kP = 64;                 // the head_dim this route takes
constexpr int kBoxBytes = kT * kRowBytes;   // one 64 x 64 bf16 box: 8 KB
constexpr int kTerms = 3;              // the stored state: hi, lo, lo2
constexpr int kStages = 2;             // the B/x ring
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* dt;     // (Bz, S, H)
  const float* A;      // (H,)
  void* y;             // (Bz, S, H, P)
  float* h_final;      // (Bz, H, P, N) or null
  int Bz, S, H, Q, R;
};

__host__ __device__ constexpr int qpad_of(int Q) {
  return (Q + kT - 1) / kT * kT;
}

// Shared memory, in bytes from a 1,024-aligned base: the state (G heads x 3
// terms x NB boxes of 64 rows v x 64 columns n: K-major, 128-byte swizzle),
// the C ring (2 slots x NB boxes), the B/x ring (kStages x (NB boxes of B +
// G boxes of x)), four f32 arrays of G x qpad (cum, dt, the update weights,
// the off-diagonal key factors), G x qpad / 64 key-tile minima of cum, and
// the mbarriers (full and free for each slot of the two rings).
struct Layout {
  uint32_t c, st, arr, bar, end;
};
__host__ __device__ constexpr Layout layout(int G, int NB, int Q) {
  const uint32_t c = (uint32_t)G * kTerms * NB * kBoxBytes;
  const uint32_t st = c + 2u * NB * kBoxBytes;
  const uint32_t arr = st + (uint32_t)kStages * (NB + G) * kBoxBytes;
  const uint32_t bar =
      arr + 4u * G * qpad_of(Q) * 4 + 4u * G * qpad_of(Q) / kT * 4;
  return {c, st, arr, bar, bar + 8 * (4 + 2 * kStages)};
}
inline size_t smem_bytes(int G, int NB, int Q) {
  return 1024 + layout(G, NB, Q).end;
}

// Byte offset of the bf16 pair (row, col), (row, col + 1) in a tile of
// 64-column boxes of 64 rows with the 128-byte swizzle.
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return (uint32_t)((col / kBox) * kBoxBytes + row * kRowBytes +
                    ((((col % kBox) / 8) ^ (row % 8)) << 4) + (col % 8) * 2);
}

__device__ __forceinline__ void bar_consumers() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t ld_u32(const unsigned char* s,
                                          uint32_t off) {
  return *reinterpret_cast<const uint32_t*>(s + off);
}
__device__ __forceinline__ void st_u32(unsigned char* s, uint32_t off,
                                       uint32_t v) {
  *reinterpret_cast<uint32_t*>(s + off) = v;
}
__device__ __forceinline__ float2 f2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// hi = bf16(a, b) and lo = bf16 of what hi leaves over, as A-fragment words.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// Which of the R blocks of a head group takes query tile t: zigzag, so that
// with R = 2 and four tiles each takes five of the ten (query, key) tile
// pairs.
__device__ __forceinline__ bool mine(int t, int r, int R) {
  const int m = t % (2 * R);
  return (m < R ? m : 2 * R - 1 - m) == r;
}

__device__ __forceinline__ void store2(float* y, size_t i, float a, float b) {
  *reinterpret_cast<float2*>(y + i) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* y, size_t i, float a,
                                       float b) {
  *reinterpret_cast<__nv_bfloat162*>(y + i) = __floats2bfloat162_rn(a, b);
}

// One head's scores of a (query tile, key tile) pair from the S = C.B^T
// fragment, straight into hi and lo A fragments (register t of step kk
// holds elements 8*kk + 2*t and + 1 of the S fragment). `rows` are the
// thread's two chunk-local query rows, p0 the tile's first key, m its least
// cum. kDirect (the diagonal): exp(cum_q - cum_p) dt_p, selected to 0 for
// q < p; else exp(cum_q - m) times the key factor exp(m - cum_p) dt_p.
template <bool kDirect>
__device__ __forceinline__ void scores(const float (&S)[32],
                                       uint32_t (&ph)[4][4],
                                       uint32_t (&pl)[4][4], const float* cum,
                                       const float* dts, const float* kf,
                                       const int (&rows)[2], int p0, int cq,
                                       float m) {
  float a[2] = {1.f, 1.f}, cr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    cr[r] = cum[rows[r]];
    if (!kDirect) a[r] = ex2((cr[r] - m) * kLog2e);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int pk = p0 + 8 * j + cq;
    float v[4];
    if (kDirect) {
      const float2 cp = *reinterpret_cast<const float2*>(cum + pk);
      const float2 dp = *reinterpret_cast<const float2*>(dts + pk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float d = cr[r] - ((e & 1) ? cp.y : cp.x);
        const float s = S[4 * j + e] * ex2(d * kLog2e) * ((e & 1) ? dp.y : dp.x);
        v[e] = rows[r] >= pk + (e & 1) ? s : 0.f;
      }
    } else {
      const float2 f = *reinterpret_cast<const float2*>(kf + pk);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = S[4 * j + e] * a[e >> 1] * ((e & 1) ? f.y : f.x);
    }
    split2(v[0], v[1], ph[j / 2][(j % 2) * 2], pl[j / 2][(j % 2) * 2]);
    split2(v[2], v[3], ph[j / 2][(j % 2) * 2 + 1], pl[j / 2][(j % 2) * 2 + 1]);
  }
}

// G heads (1 or 2), NB boxes of N (1: N = 64, 2: N = 128), TO: y's type.
// Grid (H / G * R, Bz): block (h0 / G * R + r, b) takes heads h0 .. h0 + G
// of batch row b, and share r of each chunk's query tiles. The m64nNk16
// fragments: thread t of the warpgroup holds rows 16*(t/32) + (t%32)/4 and
// that + 8; element 4*j + e of an N-wide fragment is column 8*j + 2*(t%4) +
// (e&1) of the first row (e < 2) or the second.
template <int G, int NB, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_tc_kernel(const __grid_constant__ CUtensorMap tmc,
                   const __grid_constant__ CUtensorMap tmb,
                   const __grid_constant__ CUtensorMap tmx,
                   const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* const sm = smem_raw + (base - smem_u32(smem_raw));
  const int Q = p.Q, qpad = qpad_of(Q), nt = qpad / kT;
  const Layout L = layout(G, NB, Q);
  float* const cum = reinterpret_cast<float*>(sm + L.arr);
  float* const dts = cum + G * qpad;
  float* const wv = dts + G * qpad;
  float* const kf = wv + G * qpad;
  float* const tmin = kf + G * qpad;    // G x nt
  const uint32_t c_full = base + L.bar, c_free = c_full + 16;
  const uint32_t s_full = c_free + 16, s_free = s_full + 8 * kStages;

  const int R = p.R, r = blockIdx.x % R, h0 = blockIdx.x / R * G;
  const int b = blockIdx.y, H = p.H, S = p.S;
  const int n_chunks = S / Q;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (uint32_t i = threadIdx.x * 16; i < L.c; i += kThreads * 16)
    *reinterpret_cast<uint4*>(sm + i) = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();                  // the zero state, before wgmma
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(c_full + 8 * s, 1);
      mbar_init(c_free + 8 * s, 4);     // one arrival per consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(s_full + 8 * s, 1);
      mbar_init(s_free + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {                      // the producer, in the consumers' order
    if (lane == 0) {
      int ci = 0, si = 0;
      // one stage: B's key tile at `row` and x of n_x heads from h0 + g0
      auto stage = [&](int row, int n_x, int g0) {
        const int st = si % kStages;
        if (si >= kStages) mbar_wait(s_free + 8 * st, (si / kStages - 1) & 1);
        const uint32_t dst = base + L.st + st * (NB + G) * kBoxBytes;
        mbar_expect_tx(s_full + 8 * st, (NB + n_x) * kBoxBytes);
        for (int c = 0; c < NB; ++c)
          tma_load(dst + c * kBoxBytes, &tmb, c * kBox, row, 0,
                   s_full + 8 * st);
        for (int g = 0; g < n_x; ++g)
          tma_load(dst + (NB + g) * kBoxBytes, &tmx, 0, h0 + g0 + g, row,
                   s_full + 8 * st);
        ++si;
      };
      for (int k = 0; k < n_chunks; ++k) {
        const int row0 = b * S + k * Q;
        for (int t = 0; t < nt; ++t) {
          if (!mine(t, r, R)) continue;
          const int cs = ci % 2;
          if (ci >= 2) mbar_wait(c_free + 8 * cs, (ci / 2 - 1) & 1);
          mbar_expect_tx(c_full + 8 * cs, NB * kBoxBytes);
          for (int c = 0; c < NB; ++c)
            tma_load(base + L.c + (cs * NB + c) * kBoxBytes, &tmc, c * kBox,
                     row0 + t * kT, 0, c_full + 8 * cs);
          ++ci;
          for (int s = 0; s <= t; ++s) stage(row0 + s * kT, G, 0);
        }
        for (int g = 0; g < G; ++g)
          for (int s = 0; s < nt; ++s) stage(row0 + s * kT, 1, g);
      }
    }
    return;
  }

  // The consumer warpgroup.
  const int row = warp * 16 + lane / 4;             // and row + 8
  const int cq = 2 * (lane % 4);
  TO* const Y = static_cast<TO*>(p.y);
  float acc[G][1][32], S_[32];
  uint32_t ph[G][4][4], pl[G][4][4];
  int ci = 0, si = 0;

  for (int k = 0; k < n_chunks; ++k) {
    const int row0 = b * S + k * Q;
    // dt; cum = cumsum(dt A), flat past Q, and each key tile's least cum,
    // m; the update weights w_p = exp(cum_last - cum_p) dt_p; the
    // off-diagonal key factors exp(m - cum_p) dt_p
    bar_consumers();                    // the last chunk's readers are done
    for (int i = threadIdx.x; i < G * qpad; i += 128) {
      const int g = i / qpad, j = i % qpad;
      dts[i] = j < Q ? p.dt[(size_t)(row0 + j) * H + h0 + g] : 0.f;
    }
    bar_consumers();
    if (warp < G) {
      const float A = p.A[h0 + warp];
      float* const cg = cum + warp * qpad;
      const float* const dg = dts + warp * qpad;
      float carry = 0.f, lo = 0.f;
      for (int i0 = 0; i0 < qpad; i0 += 32) {
        float v = dg[i0 + lane] * A;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += u;
        }
        v += carry;
        cg[i0 + lane] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
        float mn = v;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
        lo = i0 % kT ? fminf(lo, mn) : mn;
        if (i0 % kT && lane == 0) tmin[warp * nt + i0 / kT] = lo;
      }
    }
    bar_consumers();
    for (int i = threadIdx.x; i < G * qpad; i += 128) {
      const int g = i / qpad, j = i % qpad;
      const float* const cg = cum + g * qpad;
      wv[i] = j < Q ? expf(cg[Q - 1] - cg[j]) * dts[i] : 0.f;
      kf[i] = j < Q ? expf(tmin[g * nt + j / kT] - cg[j]) * dts[i] : 0.f;
    }
    bar_consumers();

    // y, query tile by query tile. Barrier waits only with no product in
    // flight, and no product inside a branch: C . B^T of key tile s + 1
    // (of s itself after the last, unused) is issued behind tile s's
    // products, and tile s + 1's stage is waited for before them.
    for (int t = 0; t < nt; ++t) {
      if (!mine(t, r, R)) continue;
      const int cs = ci % 2;
      const uint32_t c_s = base + L.c + cs * NB * kBoxBytes;
      const int rows[2] = {t * kT + row, t * kT + row + 8};
      mbar_wait(c_full + 8 * cs, (ci / 2) & 1);
      mbar_wait(s_full + 8 * (si % kStages), (si / kStages) & 1);
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[g][0][e] = 0.f;
        pin(acc[g][0]);
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) S_[e] = 0.f;
      pin(S_);
      wg_fence();
#pragma unroll
      for (int g = 0; g < G; ++g) {     // state read: C h_hi^T + C h_lo^T
        start_qk<NB, kT>(acc[g][0], c_s, base + g * kTerms * NB * kBoxBytes);
        start_qk<NB, kT>(acc[g][0], c_s,
                         base + (g * kTerms + 1) * NB * kBoxBytes);
      }
      start_qk<NB, kT>(S_, c_s,
                       base + L.st + (si % kStages) * (NB + G) * kBoxBytes);
      for (int s = 0; s <= t; ++s) {
        const int st = si % kStages, nx = (si + (s < t)) % kStages;
        const uint32_t b_s = base + L.st + st * (NB + G) * kBoxBytes;
        wg_wait<0>();                   // S of tile s (and the last products)
        pin(S_);
#pragma unroll
        for (int g = 0; g < G; ++g) pin(acc[g][0]);
        if (s > 0 && lane == 0) mbar_arrive(s_free + 8 * ((si - 1) % kStages));
        if (s == 0) {                   // the state read times exp(cum_q)
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float* const cg = cum + g * qpad;
            const float e0 = expf(cg[rows[0]]), e1 = expf(cg[rows[1]]);
#pragma unroll
            for (int e = 0; e < 32; ++e) acc[g][0][e] *= (e & 2) ? e1 : e0;
          }
        }
        if (s < t) mbar_wait(s_full + 8 * nx, ((si + 1) / kStages) & 1);
#pragma unroll
        for (int g = 0; g < G; ++g) {   // head g + 1's scores during g's product
          if (s == t)
            scores<true>(S_, ph[g], pl[g], cum + g * qpad, dts + g * qpad,
                         kf + g * qpad, rows, s * kT, cq, 0.f);
          else
            scores<false>(S_, ph[g], pl[g], cum + g * qpad, dts + g * qpad,
                          kf + g * qpad, rows, s * kT, cq,
                          tmin[g * nt + s]);
          if (g == G - 1) {
#pragma unroll
            for (int e = 0; e < 32; ++e) S_[e] = 0.f;
            pin(S_);
          }
          pin(acc[g][0]);
          pin(ph[g]);
          pin(pl[g]);
          wg_fence();
          start_pv<1, kT>(acc[g], ph[g], pl[g], b_s + (NB + g) * kBoxBytes);
        }
        start_qk<NB, kT>(S_, c_s, base + L.st + nx * (NB + G) * kBoxBytes);
        ++si;
      }
      wg_wait<0>();
      pin(S_);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        pin(acc[g][0]);
        pin(ph[g]);
        pin(pl[g]);
      }
      if (lane == 0) {
        mbar_arrive(s_free + 8 * ((si - 1) % kStages));
        mbar_arrive(c_free + 8 * cs);
      }
      ++ci;
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
            if (rows[rr] < Q)
              store2(Y,
                     ((size_t)(row0 + rows[rr]) * H + h0 + g) * kP + 8 * j + cq,
                     acc[g][0][4 * j + 2 * rr], acc[g][0][4 * j + 2 * rr + 1]);
    }

    // the state update, once every state read of the chunk is done
    bar_consumers();
    const bool last = k + 1 == n_chunks;
#pragma unroll 1
    for (int g = 0; g < G; ++g) {
      const float* const wg = wv + g * qpad;
      const float dec = expf(cum[g * qpad + Q - 1]);
      unsigned char* const hs = sm + g * kTerms * NB * kBoxBytes;
      float hacc[NB][32];
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const uint32_t off = swz(row + 8 * rr, c * kBox + 8 * j + cq);
            const float2 hi = f2(ld_u32(hs, off));
            const float2 lo = f2(ld_u32(hs, off + NB * kBoxBytes));
            const float2 l2 = f2(ld_u32(hs, off + 2 * NB * kBoxBytes));
            hacc[c][4 * j + 2 * rr] = dec * ((hi.x + lo.x) + l2.x);
            hacc[c][4 * j + 2 * rr + 1] = dec * ((hi.y + lo.y) + l2.y);
          }
      for (int s = 0; s < nt; ++s) {
        const int st = si % kStages;
        const uint32_t b_s = base + L.st + st * (NB + G) * kBoxBytes;
        const uint32_t x_s = b_s + NB * kBoxBytes;
        mbar_wait(s_full + 8 * st, (si / kStages) & 1);
        // A = (x w)^T, rows v and columns p: ldmatrix.trans of the x tile's
        // 8 x 8 pieces (8 rows p, 16 bytes of v each) gives the A fragment
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int pr = 16 * kk + (lane & 7) + ((lane >> 4) << 3);
          const int ch = 2 * warp + ((lane >> 3) & 1);
          uint32_t xr[4];
          ldsm_x4_t(xr, x_s + pr * kRowBytes + ((ch ^ (pr & 7)) << 4));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int pk = s * kT + 16 * kk + cq + ((i & 2) << 2);
            const float2 w = *reinterpret_cast<const float2*>(wg + pk);
            const float2 xv = f2(xr[i]);
            split2(xv.x * w.x, xv.y * w.y, ah[kk][i], al[kk][i]);
          }
        }
#pragma unroll
        for (int c = 0; c < NB; ++c) pin(hacc[c]);
        pin(ah);
        pin(al);
        wg_fence();
        start_pv<NB, kT>(hacc, ah, al, b_s);   // h += A_hi B + A_lo B
        wg_wait<0>();
#pragma unroll
        for (int c = 0; c < NB; ++c) pin(hacc[c]);
        pin(ah);
        pin(al);
        if (lane == 0) mbar_arrive(s_free + 8 * st);
        ++si;
      }
      // the new state: three bf16 terms for the next chunk; f32 out at the end
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int v = row + 8 * rr, n = c * kBox + 8 * j + cq;
            const float x0 = hacc[c][4 * j + 2 * rr];
            const float x1 = hacc[c][4 * j + 2 * rr + 1];
            if (last) {
              if (p.h_final != nullptr && r == 0)
                *reinterpret_cast<float2*>(
                    p.h_final +
                    (((size_t)b * H + h0 + g) * kP + v) * (NB * kBox) + n) =
                    make_float2(x0, x1);
              continue;
            }
            const uint32_t off = swz(v, n);
            uint32_t hi, lo;
            split2(x0, x1, hi, lo);
            const float2 hf = f2(hi), lf = f2(lo);
            st_u32(hs, off, hi);
            st_u32(hs, off + NB * kBoxBytes, lo);
            st_u32(hs, off + 2 * NB * kBoxBytes,
                   bits(__floats2bfloat162_rn((x0 - hf.x) - lf.x,
                                              (x1 - hf.y) - lf.y)));
          }
    }
    fence_proxy_async();                // the new state, before wgmma reads it
  }
}

// A bf16 tensor of `rows` rows x `mid` x `cols` columns (strides in
// elements), read in boxes of 64 columns x box_mid x box_rows.
bool tensor_map(CUtensorMap* map, const void* ptr, int cols, int mid,
                int rows, cuuint64_t mid_stride, cuuint64_t row_stride,
                cuuint32_t box_mid, cuuint32_t box_rows) {
  return tensor_map_3d(map, ptr,
                       {(cuuint64_t)cols, (cuuint64_t)mid, (cuuint64_t)rows},
                       {mid_stride * 2, row_stride * 2},
                       {(cuuint32_t)kBox, box_mid, box_rows});
}

template <int G, int NB, typename TO>
cudaError_t launch(const void* x, const void* B, const void* C,
                   const Params& p, cudaStream_t stream) {
  const int N = NB * kBox, rows = p.Bz * p.S;
  CUtensorMap tmc, tmb, tmx;
  // C and B (Bz*S, N) as {N, Bz*S, 1}; x (Bz*S, H, P) as {P, H, Bz*S}
  if (!tensor_map(&tmc, C, N, rows, 1, N, (cuuint64_t)rows * N, kT, 1) ||
      !tensor_map(&tmb, B, N, rows, 1, N, (cuuint64_t)rows * N, kT, 1) ||
      !tensor_map(&tmx, x, kP, p.H, rows, kP, (cuuint64_t)p.H * kP, 1, kT))
    return cudaErrorInvalidValue;
  auto kern = ssd_scan_tc_kernel<G, NB, TO>;
  const size_t smem = smem_bytes(G, NB, p.Q);
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(p.H / G * p.R, p.Bz), kThreads, smem, stream>>>(tmc, tmb, tmx,
                                                              p);
  return cudaGetLastError();
}

template <int G, int NB>
cudaError_t launch_out(const void* x, const void* B, const void* C,
                       const Params& p, bool out_bf16, cudaStream_t stream) {
  return out_bf16 ? launch<G, NB, __nv_bfloat16>(x, B, C, p, stream)
                  : launch<G, NB, float>(x, B, C, p, stream);
}

}  // namespace tc

}  // namespace

// The simt route's dynamic shared memory a block, in bytes.
extern "C" long long ssd_scan_simt_smem_bytes(int N, int Q) {
  return (long long)(smem_floats(N, Q) * sizeof(float));
}

// The simt route. Launches on `stream` and returns cudaGetLastError() (0
// on success). The caller checks devices, types and contiguity; x, B and C are f32 or bf16
// (in_bf16), y is f32 or bf16 (out_bf16), dt and A are f32. h_final may be
// null. Takes S % Q == 0, 1 <= P <= 64, 1 <= N <= 128.
extern "C" int ssd_scan_simt_launch(const void* x, const float* dt,
                                    const float* A, const void* B,
                                    const void* C, void* y, float* h_final,
                                    int Bz, int S, int H, int P, int N, int Q,
                                    int in_bf16, int out_bf16, void* stream) {
  if (Bz == 0 || S == 0 || H == 0) return (int)cudaSuccess;
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 || S % Q)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(N, Q) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const Params p{x, dt, A, B, C, y, h_final, Bz, S, H, P, N, Q};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (in_bf16)
    e = out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(p, smem, st)
                 : launch<__nv_bfloat16, float>(p, smem, st);
  else
    e = out_bf16 ? launch<float, __nv_bfloat16>(p, smem, st)
                 : launch<float, float>(p, smem, st);
  return (int)e;
}

// The tc route's dynamic shared memory a block, in bytes.
extern "C" long long ssd_scan_tc_smem_bytes(int G, int N, int Q) {
  return (long long)tc::smem_bytes(G, N / 64, Q);
}

// The tc route: x, B and C bf16, 16-byte aligned, contiguous; P = 64,
// N = 64 or 128; G = 1 or 2 heads a block (H % G == 0), R >= 1 blocks a
// head group. Launches on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int ssd_scan_tc_launch(const void* x, const float* dt,
                                  const float* A, const void* B,
                                  const void* C, void* y, float* h_final,
                                  int Bz, int S, int H, int P, int N, int Q,
                                  int G, int R, int out_bf16, void* stream) {
  if (Bz == 0 || S == 0 || H == 0) return (int)cudaSuccess;
  if (P != tc::kP || (N != 64 && N != 128) || (G != 1 && G != 2) ||
      H % G || R < 1 || Q < 1 || S % Q ||
      tc::smem_bytes(G, N / 64, Q) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const tc::Params p{dt, A, y, h_final, Bz, S, H, Q, R};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ob = out_bf16 != 0;
  cudaError_t e;
  if (G == 1)
    e = N == 64 ? tc::launch_out<1, 1>(x, B, C, p, ob, st)
                : tc::launch_out<1, 2>(x, B, C, p, ob, st);
  else
    e = N == 64 ? tc::launch_out<2, 1>(x, B, C, p, ob, st)
                : tc::launch_out<2, 2>(x, B, C, p, ob, st);
  return (int)e;
}
