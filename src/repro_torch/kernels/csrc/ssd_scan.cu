// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::_kernel (called
// through ssd_scan), and computes what the model's XLA path
// src/repro/models/ssm.py::ssd_chunked computes. Per chunk of Q time steps
// of one (batch row b, head h), with cum = cumsum(dt * A) over the chunk:
//   intra-chunk dual  y[q]  = sum_{p<=q} (C_q . B_p) exp(cum_q - cum_p) dt_p x_p
//   state read        y[q] += exp(cum_q) (C_q . h[v, :])      (h at chunk start)
//   state update      h      = exp(cum_last) h + sum_p x_p (B_p exp(cum_last - cum_p) dt_p)
// The (P x N) f32 state is carried from chunk to chunk; the final one is
// written out when asked for (the model's prefill keeps it as its cache).
//
// What bounds it on this card: at the serving shapes (P = 64, N = 128,
// Q = 256, bf16 in, f32 out) the four products do ~290 flops per byte the
// scan must move, right at the ~295 flop/byte where an H100's bf16 tensor
// cores and its memory take the same time. This first design does the
// products in f32 on the CUDA cores (67 TFLOP/s, not 989), so it is
// compute-bound. It keeps everything but the inputs and outputs on chip:
// the state lives in shared memory for the whole scan and never goes
// through device memory between chunks.
//
// One thread block (256 threads) per (head h, batch row b) walks the chunks
// in order. A Q x Q f32 score tile at Q = 256 is 256 KB, above the 227 KB
// a block may hold, so each chunk is cut into 64-row query tiles, and each
// query tile walks the 64-key tiles at or before it:
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
// Left for later PRs:
//   * tensor-core (mma / wgmma) products in bf16 with f32 accumulation;
//   * B and C are shared by all H heads, but each head's block re-reads
//     them (L2 should catch that); one block could serve several heads;
//   * at batch 1 only H = 64 blocks run on 132 SMs; split the state update
//     or the heads' P axis to fill the card;
//   * cp.async / TMA double-buffering of the B, C and x tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

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
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(const Params p) {
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
  auto kern = ssd_scan_kernel<TI, TO>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(p.H, p.Bz), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one block of the kernel takes, in bytes.
extern "C" long long ssd_scan_smem_bytes(int N, int Q) {
  return (long long)(smem_floats(N, Q) * sizeof(float));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller checks devices, types and contiguity; x, B and C are f32 or bf16
// (in_bf16), y is f32 or bf16 (out_bf16), dt and A are f32. h_final may be
// null. Takes S % Q == 0, 1 <= P <= 64, 1 <= N <= 128.
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A,
                               const void* B, const void* C, void* y,
                               float* h_final, int Bz, int S, int H, int P,
                               int N, int Q, int in_bf16, int out_bf16,
                               void* stream) {
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
