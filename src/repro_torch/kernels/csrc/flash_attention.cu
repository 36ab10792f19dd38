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
// What bounds it on this card: operations. A (q, k) pair costs 2*(D+Dv)
// flops for 2*(D+Dv)/S bytes of its k and v rows, so at prefill lengths the
// work is hundreds of flops per byte, above the ~295 flop/byte where an
// H100's bf16 tensor cores and its memory take the same time (qwen3-14b at
// 4,096 tokens: 1.7e11 flops against 0.1 GB). This first design does the
// two products in f32 on the CUDA cores (67 TFLOP/s, not the tensor cores'
// 989), so it is compute-bound on them. It keeps what it can on chip so the
// bytes stay far below that: each k and v tile is loaded once per query
// tile and used by all its 64 rows; the running max m, sum l and the output
// accumulator live in registers for the whole key walk; the score tile
// never leaves shared memory.
//
// One block of 256 threads per (query tile of 64 rows, head h, batch row b);
// the TPU grid's sequential key axis becomes the loop over 64-key tiles
// inside the block. Per key tile:
//   1. stage k (and v) in their own type (bf16 stays bf16; widened to f32 in
//      registers); q was staged once, widened to f32, since every key tile
//      reads it again; rows past Sq or Sk are zero-filled, never read from
//      device memory;
//   2. scores on a 4 x 4 register tile per thread (rows ty*4+i, keys
//      tx+16*j), f32 from 4-element vector loads; scale, softcap, mask;
//   3. online softmax per row: max and sum by shuffles across the 16 threads
//      that share a row, alpha = exp(m_old - m_new), p to shared memory;
//   4. acc = acc * alpha + p @ v, each thread 4 rows x 2*NP columns.
// Key tiles that the causal mask or the window hides completely are skipped
// before any load: they would add p = 0 and leave m as it is. Query tiles are
// scheduled last-first, so the longest causal rows start first.
//
// Shared memory at D = Dv = 256 in f32: q 66.6 KB + k 66.6 KB + v 65.5 KB +
// scores 17.4 KB = 216 KB of the 227 KB a block may use; in bf16 150 KB.
//
// Left for later PRs:
//   * the products on the tensor cores (mma / wgmma, bf16 in, f32 out), which
//     is where the 15x between this kernel's peak and the card's lies;
//   * cp.async / TMA double-buffering, so the next k/v tile loads while this
//     one is in use (today every tile waits on its own load);
//   * one block serving the G query heads of a kv head (k and v are re-read
//     per query head now; L2 catches most of it);
//   * split-K over the key axis when B*H*(Sq/64) blocks do not fill 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;           // 16 x 16
constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per tile
constexpr int kPad = 4;                 // q and k rows: D + 4 elements
constexpr int kLdp = kBK + 4;           // score tile row stride (floats)
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

// Four consecutive elements, widened to f32.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
// Two consecutive elements, widened to f32.
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p);
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Four elements moved as one vector: 16 bytes in f32, 8 in bf16.
template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<__nv_bfloat16> { using type = uint2; };

// Copy `valid` rows of width W (a multiple of 4) from src (row stride W) to
// dst (row stride ld), zero-filling rows [valid, rows).
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src, int W,
                                      int rows, int valid) {
  using V = typename Vec4<T>::type;
  const int per_row = W / 4;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * 4;
    V x = {};
    if (r < valid) x = *reinterpret_cast<const V*>(src + (size_t)r * W + c);
    *reinterpret_cast<V*>(dst + r * ld + c) = x;
  }
}

// Dynamic shared memory of one block, in bytes: q (f32), scores (f32), then
// k and v in the input type. Every array starts on a 16-byte boundary.
inline size_t smem_bytes(int D, int np, size_t elem) {
  return (size_t)kBQ * (D + kPad) * 4 + (size_t)kBQ * kLdp * 4 +
         (size_t)kBK * (D + kPad) * elem + (size_t)kBK * 32 * np * elem;
}

// NP: pairs of output columns per thread (Dv <= 32 * NP).
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];
  const int D = p.D, Dv = p.Dv, ld = D + kPad, ldv = 32 * NP;
  float* const q_s = reinterpret_cast<float*>(smem4);    // kBQ x ld
  float* const p_s = q_s + kBQ * ld;                      // kBQ x kLdp
  T* const k_s = reinterpret_cast<T*>(p_s + kBQ * kLdp);  // kBK x ld
  T* const v_s = k_s + kBK * ld;                          // kBK x ldv

  const int nq = (p.Sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* const Q = static_cast<const T*>(p.q) +
                     ((size_t)b * p.H + h) * p.Sq * D;
  const T* const Kg = static_cast<const T*>(p.k) +
                      ((size_t)b * p.K + kh) * p.Sk * D;
  const T* const Vg = static_cast<const T*>(p.v) +
                      ((size_t)b * p.K + kh) * p.Sk * Dv;
  T* const O = static_cast<T*>(p.o) + ((size_t)b * p.H + h) * p.Sq * Dv;

  // the key tiles this query tile can see
  const int q_last = min(q0 + kBQ, p.Sq) - 1;
  int k_begin = 0, k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q_last + 1);
  if (p.has_window) k_begin = max(0, q0 - p.window + 1);
  k_begin = k_begin / kBK * kBK;

  // q once, widened to f32; v's pad columns [Dv, ldv) stay zero throughout
  for (int i = tid; i < kBQ * (D / 4); i += kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < p.Sq) x = ld4(Q + (size_t)(q0 + r) * D + c);
    *reinterpret_cast<float4*>(q_s + r * ld + c) = x;
  }
  for (int i = tid; i < kBK * (ldv - Dv); i += kThreads) {
    const int r = i / (ldv - Dv), c = Dv + i % (ldv - Dv);
    v_s[r * ldv + c] = from_f32<T>(0.f);
  }

  float m[4], l[4], acc[4][2 * NP];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 2 * NP; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();                    // the last tile's k, v, p are used
    const int valid = min(kBK, p.Sk - k0);
    stage(k_s, ld, Kg + (size_t)k0 * D, D, kBK, valid);
    stage(v_s, ldv, Vg + (size_t)k0 * Dv, Dv, kBK, valid);
    __syncthreads();

    // 2. s = q . k on a 4 x 4 tile: rows ty*4+i, keys tx+16*j
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
      for (int j = 0; j < 4; ++j) kv[j] = ld4(k_s + (tx + 16 * j) * ld + d);
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

    // 3. scale, softcap, mask; online softmax across the row's 16 threads
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

    // 4. acc += p @ v: rows ty*4+i, columns 2*tx + 32*t + {0, 1}
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] =
            *reinterpret_cast<const float4*>(p_s + (ty * 4 + i) * kLdp + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const T* const vrow = v_s + (j + jj) * ldv + 2 * tx;
#pragma unroll
        for (int t = 0; t < NP; ++t) {
          const float2 x = ld2(vrow + 32 * t);
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
        st2(O + (size_t)q * Dv + c, acc[i][2 * t] / den,
            acc[i][2 * t + 1] / den);
    }
  }
}

template <typename T, int NP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, NP>;
  const size_t smem = smem_bytes(p.D, NP, sizeof(T));
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

template <typename T>
cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  if (p.Dv <= 32) return launch<T, 1>(p, stream);
  if (p.Dv <= 64) return launch<T, 2>(p, stream);
  if (p.Dv <= 128) return launch<T, 4>(p, stream);
  if (p.Dv <= 160) return launch<T, 5>(p, stream);
  return launch<T, 8>(p, stream);
}

int np_of(int Dv) {
  return Dv <= 32 ? 1 : Dv <= 64 ? 2 : Dv <= 128 ? 4 : Dv <= 160 ? 5 : 8;
}

}  // namespace

// Dynamic shared memory one block takes, in bytes.
extern "C" long long flash_attention_smem_bytes(int D, int Dv, int bf16) {
  return (long long)smem_bytes(D, np_of(Dv), bf16 ? 2 : 4);
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
  return (int)(bf16 ? dispatch<__nv_bfloat16>(p, st) : dispatch<float>(p, st));
}
