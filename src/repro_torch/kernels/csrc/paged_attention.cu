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
// What bounds it on this card: the bytes of the K/V pages it reads. At
// decode every query row does 2*(Dk+Dv) flops per 2*(Dk+Dv) bytes of K/V, far
// below the ~295 flop/byte where an H100 turns compute-bound, so the kernel
// is memory-bound. The design answers that by loading each live K/V page from
// device memory ONCE per block and sharing it, in shared memory, across all
// G query heads of the block's kv head (and across the block's query rows at
// prefill). Math is f32 on the CUDA cores; the tensor cores are not needed
// at these intensities.
//
// One thread block per (q-row chunk, kv head kh, slot b). A block's rows are
// (query i, group g) pairs of that (b, kh), flattened as i*G + g, so G heads
// share every staged page whatever the value of G. Per live page:
//   1. stage ps rows of K (and K2) and V, converted to f32, plus kpos;
//   2. one thread per (row, key): s = (q.k [+ q2.k2]) * scale, softcap, mask;
//   3. one thread per row: online-softmax update of running max m, sum l,
//      rescale factor alpha; p = exp(s - m_new), RE-MASKED after the exp (an
//      all-masked prefix leaves m_new = -1e30 and exp(s - m_new) = 1);
//   4. one thread per (row, output column): acc = acc*alpha + p.V.
// The output is acc / (l > 0 ? l : 1).
//
// Left for later PRs:
//   * split-K over pages for small-batch decode: 4 slots x 8 kv heads is only
//     32 blocks on 132 SMs, and each walks its pages alone;
//   * TMA or cp.async double-buffering of pages, so the next page's load
//     overlaps this page's math (today every page waits on its own load);
//   * tensor-core (wgmma) products for long prefill rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

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
