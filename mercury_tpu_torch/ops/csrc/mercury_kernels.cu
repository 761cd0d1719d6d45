// Hand-written Hopper kernels of the importance-sampling step.
//
// Built by ops/_build.py with nvcc for sm_90a into a shared library with a
// plain C interface, loaded from Python with ctypes (ops/mercury_kernels.py).
// Each entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() of its launch.
//
// 1. nll_fwd  — replaces _nll_fwd_raw / _nll_kernel
//               (mercury_tpu/ops/mercury_kernels.py:66-91).
//    nll_i = logsumexp(z_i) - z_i[y_i], float32 out, bf16 or f32 logits.
//    Bound: bytes (N·C logits read once, N labels, N losses written). At the
//    step's [320,10] and [32,10] that is ~15 KB and ~1.5 KB: the launch, not
//    the memory, sets the time. One warp per row, shuffle reductions, no
//    shared memory; 8 rows per 256-thread block.
// 2. nll_bwd  — replaces _vjp_bwd / _nll_bwd_kernel (:94-139).
//    grad_ij = (softmax(z_i)_j - [j == y_i])·g_i, written in the logits'
//    dtype. Same layout and bound as nll_fwd.
// 3. score_and_draw — replaces score_and_draw_pallas / _score_draw_kernel /
//    _inverse_cdf_draw (:146-302).
//    s = max(loss + a·ema, 1e-12), p = s/Σs, cdf = inclusive scan of p,
//    idx_b = min(#{j : cdf_j <= u_b}, N-1), scaled_b = p[idx_b]·N.
//    One block: the sum, the scan and the B searches all need the whole
//    pool, and a pool of tens of thousands of floats is a few hundred KB —
//    one SM streams it in microseconds, far below a second launch. The scan
//    walks the pool in 1024-wide tiles (warp shuffle scan, then a scan of
//    the 32 warp totals) with a running carry, so any N works and nothing
//    is padded. Each draw is then a binary search (upper bound) over the
//    cdf. Bound: bytes (N losses read, N probs written), again launch-bound
//    at N = 320.
//    The float sums run in another order than the TPU kernel's chunked
//    matmul prefix, so a u_b within ~1e-6 of a cdf value can land one index
//    over; tests and chip_smoke.py count such u and require equal indices
//    outside that band.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerBlock = 8;
constexpr int kRowThreads = kRowsPerBlock * kWarp;
constexpr int kDrawThreads = 1024;
constexpr int kDrawWarps = kDrawThreads / kWarp;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Row max and sum of exp(z - max) of one row, spread over a warp's lanes.
template <typename T>
__device__ __forceinline__ void row_stats(const T* z, int c, int lane,
                                          float* m_out, float* s_out) {
  float m = -INFINITY;
  for (int j = lane; j < c; j += kWarp) m = fmaxf(m, load_f32(z + j));
  m = warp_max(m);
  float s = 0.f;
  for (int j = lane; j < c; j += kWarp) s += expf(load_f32(z + j) - m);
  *m_out = m;
  *s_out = warp_sum(s);
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
nll_fwd_kernel(const T* __restrict__ logits, const int32_t* __restrict__ labels,
               float* __restrict__ out, int n, int c) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n) return;  // uniform across the warp
  const T* z = logits + static_cast<size_t>(row) * c;
  const int y = labels[row];
  float m, s;
  row_stats(z, c, lane, &m, &s);
  // The label is compared with the column index, never used as an address:
  // a label outside [0, C) picks nothing and the loss is the logsumexp.
  float picked = 0.f;
  for (int j = lane; j < c; j += kWarp)
    if (j == y) picked = load_f32(z + j);
  picked = warp_sum(picked);
  if (lane == 0) out[row] = (logf(s) + m) - picked;
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
nll_bwd_kernel(const T* __restrict__ logits, const int32_t* __restrict__ labels,
               const float* __restrict__ g, T* __restrict__ grad, int n, int c) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n) return;
  const size_t off = static_cast<size_t>(row) * c;
  const T* z = logits + off;
  const int y = labels[row];
  float m, s;
  row_stats(z, c, lane, &m, &s);
  const float gi = g[row];
  for (int j = lane; j < c; j += kWarp) {
    const float p = expf(load_f32(z + j) - m) / s;
    const float onehot = (j == y) ? 1.f : 0.f;
    store_from_f32(grad + off + j, (p - onehot) * gi);
  }
}

// Smoothed, floored score; `a` is alpha·ema rounded once, as in the plain
// version (kept apart from the add so nothing contracts it into an fma).
__device__ __forceinline__ float score_of(float loss, float a) {
  return fmaxf(__fadd_rn(loss, a), 1e-12f);
}

__global__ void __launch_bounds__(kDrawThreads)
score_and_draw_kernel(const float* __restrict__ losses, const float* __restrict__ ema,
                      const float* __restrict__ uniforms, float alpha, int n, int b,
                      float* probs, float* cdf, int32_t* __restrict__ selected,
                      float* __restrict__ scaled) {
  __shared__ float warp_buf[kDrawWarps];
  __shared__ float total_s;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const float a = __fmul_rn(alpha, *ema);

  // Σ scores: per-thread strided sums, then warp and block reductions.
  float local = 0.f;
  for (int i = tid; i < n; i += kDrawThreads) local += score_of(losses[i], a);
  local = warp_sum(local);
  if (lane == 0) warp_buf[warp] = local;
  __syncthreads();
  if (warp == 0) {
    float w = warp_sum(warp_buf[lane]);
    if (lane == 0) total_s = w;
  }
  __syncthreads();
  const float total = total_s;

  // probs and their inclusive scan, one 1024-wide tile at a time.
  float carry = 0.f;
  for (int base = 0; base < n; base += kDrawThreads) {
    const int i = base + tid;
    float p = 0.f;
    if (i < n) {
      p = score_of(losses[i], a) / total;
      probs[i] = p;
    }
    float x = p;
    for (int o = 1; o < kWarp; o <<= 1) {
      const float y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == kWarp - 1) warp_buf[warp] = x;
    __syncthreads();
    if (warp == 0) {
      float w = warp_buf[lane];
      for (int o = 1; o < kWarp; o <<= 1) {
        const float y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      warp_buf[lane] = w;
    }
    __syncthreads();
    const float before = (warp > 0) ? warp_buf[warp - 1] : 0.f;
    if (i < n) cdf[i] = carry + (before + x);
    carry += warp_buf[kDrawWarps - 1];
    __syncthreads();  // warp_buf is rewritten by the next tile
  }
  // The barrier above also makes every thread's probs/cdf writes visible.

  for (int k = tid; k < b; k += kDrawThreads) {
    const float u = uniforms[k];
    int lo = 0, hi = n;  // first j with cdf_j > u
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cdf[mid] <= u) lo = mid + 1; else hi = mid;
    }
    const int idx = min(lo, n - 1);
    selected[k] = idx;
    scaled[k] = probs[idx] * static_cast<float>(n);
  }
}

inline int blocks_for_rows(int n) { return (n + kRowsPerBlock - 1) / kRowsPerBlock; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.
int mercury_nll_fwd(const void* logits, const void* labels, void* out, int n, int c,
                    int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    nll_fwd_kernel<float><<<blocks_for_rows(n), kRowThreads, 0, st>>>(
        static_cast<const float*>(logits), static_cast<const int32_t*>(labels),
        static_cast<float*>(out), n, c);
  } else if (dtype == 1) {
    nll_fwd_kernel<__nv_bfloat16><<<blocks_for_rows(n), kRowThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), static_cast<const int32_t*>(labels),
        static_cast<float*>(out), n, c);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int mercury_nll_bwd(const void* logits, const void* labels, const void* g, void* grad,
                    int n, int c, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    nll_bwd_kernel<float><<<blocks_for_rows(n), kRowThreads, 0, st>>>(
        static_cast<const float*>(logits), static_cast<const int32_t*>(labels),
        static_cast<const float*>(g), static_cast<float*>(grad), n, c);
  } else if (dtype == 1) {
    nll_bwd_kernel<__nv_bfloat16><<<blocks_for_rows(n), kRowThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), static_cast<const int32_t*>(labels),
        static_cast<const float*>(g), static_cast<__nv_bfloat16*>(grad), n, c);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int mercury_score_and_draw(const void* losses, const void* ema, const void* uniforms,
                           float alpha, int n, int b, void* probs, void* cdf,
                           void* selected, void* scaled, void* stream) {
  score_and_draw_kernel<<<1, kDrawThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(losses), static_cast<const float*>(ema),
      static_cast<const float*>(uniforms), alpha, n, b, static_cast<float*>(probs),
      static_cast<float*>(cdf), static_cast<int32_t*>(selected),
      static_cast<float*>(scaled));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
