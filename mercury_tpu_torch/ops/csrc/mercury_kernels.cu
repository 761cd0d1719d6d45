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
// 4. table_refresh_draw — replaces table_refresh_draw_pallas /
//    _table_refresh_draw_kernel (:306-423).
//    t_i = mu + (t_i - mu)·decay for every slot; each refresh slot s then
//    takes the mean of the R refresh scores aimed at it (duplicates
//    averaged, summed in index order); then score_and_draw's normalize,
//    scan and draw over the whole table, with scaled_b = p[idx_b]·L.
//    One block, for the reason score_and_draw has one: the sum, the scan
//    and the draws need the whole table, and L = 50,000 floats is 200 KB.
//    The scatter is R threads each scanning the R slots (R = 64: 4096
//    compares), with a barrier on each side, so no atomics and no order
//    that changes from run to run. The true L is used, with no padding (the
//    TPU wrapper pads awkward L to a multiple of 512 for Mosaic only).
//    Bound: bytes (L read, 2L written, 12R + 12B more), launch-bound at
//    L = 5000 and a one-SM scan at L = 50,000.
// 5. augment_normalize — replaces augment_normalize_pallas /
//    _augment_norm_kernel (:427-551).
//    out[n,y,x,c] = (fma(u8, RN(1/255), -mean_c) / std_c) at the source
//    pixel (y + oy - pad, (flip ? W-1-x : x) + ox - pad), +0.0 outside the
//    image, cast to f32 or bf16 as the last op. One thread per output
//    element of the NHWC output, so neighbouring threads write neighbouring
//    addresses and read neighbouring source bytes (a row of the crop is a
//    contiguous run of the source row, reversed under a flip). The
//    arithmetic is the TPU kernel's as XLA compiles it: the division by the
//    constant 255 is a multiply by its rounded reciprocal fused with the
//    subtraction of the mean; the division by std is a true division. The
//    intrinsics spell out each rounding, so nvcc's -fmad contraction cannot
//    change a bit and the f32 output equals the plain version's exactly.
//    Bound: bytes (N·H·W·C bytes read, 4 or 2 times that written).

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
constexpr int kPixelThreads = 256;
constexpr float kInv255 = 0x1.010102p-8f;  // 1/255 rounded to float32

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

// The block's normalize-and-draw over n values already in memory:
// p_i = score_of(vals_i, a) / Σ into probs, their inclusive scan into cdf,
// then for each uniform the upper bound of u in cdf, clamped to n - 1, and
// scaled_b = p[idx_b]·n. Called by every thread of a kDrawThreads block;
// vals may have been written by this block before a barrier.
__device__ __forceinline__ void normalize_and_draw(
    const float* vals, float a, int n, const float* __restrict__ uniforms, int b,
    float* probs, float* cdf, int32_t* __restrict__ selected,
    float* __restrict__ scaled) {
  __shared__ float warp_buf[kDrawWarps];
  __shared__ float total_s;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;

  // Σ scores: per-thread strided sums, then warp and block reductions.
  float local = 0.f;
  for (int i = tid; i < n; i += kDrawThreads) local += score_of(vals[i], a);
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
      p = score_of(vals[i], a) / total;
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

__global__ void __launch_bounds__(kDrawThreads)
score_and_draw_kernel(const float* __restrict__ losses, const float* __restrict__ ema,
                      const float* __restrict__ uniforms, float alpha, int n, int b,
                      float* probs, float* cdf, int32_t* __restrict__ selected,
                      float* __restrict__ scaled) {
  normalize_and_draw(losses, __fmul_rn(alpha, *ema), n, uniforms, b, probs, cdf,
                     selected, scaled);
}

// new_table is written and then read back by this block, so it is neither
// const nor __restrict__: its reads must not go through the read-only cache.
__global__ void __launch_bounds__(kDrawThreads)
table_refresh_draw_kernel(const float* __restrict__ table, const int64_t* __restrict__ slots,
                          const float* __restrict__ rscores, const float* __restrict__ ema,
                          const float* __restrict__ uniforms, float alpha, float decay,
                          int n, int r, int b, float* new_table, float* probs, float* cdf,
                          int32_t* __restrict__ selected, float* __restrict__ scaled) {
  const int tid = threadIdx.x;
  const float mu = *ema;
  for (int i = tid; i < n; i += kDrawThreads)
    new_table[i] = __fadd_rn(mu, __fmul_rn(__fsub_rn(table[i], mu), decay));
  __syncthreads();
  // Entry k writes the mean of every refresh score aimed at its slot; the
  // entries of one slot write the same value. A slot outside [0, L) is
  // skipped, never used as an address.
  for (int k = tid; k < r; k += kDrawThreads) {
    const int64_t s = slots[k];
    if (s < 0 || s >= n) continue;
    float sum = 0.f;
    int count = 0;
    for (int j = 0; j < r; ++j) {
      if (slots[j] == s) {
        sum = __fadd_rn(sum, rscores[j]);
        ++count;
      }
    }
    new_table[s] = __fdiv_rn(sum, static_cast<float>(count));
  }
  __syncthreads();
  normalize_and_draw(new_table, __fmul_rn(alpha, mu), n, uniforms, b, probs, cdf,
                     selected, scaled);
}

template <typename T>
__global__ void __launch_bounds__(kPixelThreads)
augment_normalize_kernel(const uint8_t* __restrict__ raw, const float* __restrict__ mean,
                         const float* __restrict__ stdev, const int32_t* __restrict__ crop,
                         const uint8_t* __restrict__ flip, T* __restrict__ out,
                         int n, int h, int w, int c, int pad) {
  const int64_t total = static_cast<int64_t>(n) * h * w * c;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kPixelThreads + threadIdx.x;
  if (idx >= total) return;
  const int ch = static_cast<int>(idx % c);
  int64_t rest = idx / c;
  const int x = static_cast<int>(rest % w);
  rest /= w;
  const int y = static_cast<int>(rest % h);
  const int img = static_cast<int>(rest / h);
  const int sy = y + crop[2 * img] - pad;
  const int sx = (flip[img] ? w - 1 - x : x) + crop[2 * img + 1] - pad;
  float v = 0.f;  // the zero padding, +0.0
  if (sy >= 0 && sy < h && sx >= 0 && sx < w) {
    const float px = static_cast<float>(
        raw[((static_cast<int64_t>(img) * h + sy) * w + sx) * c + ch]);
    v = __fdiv_rn(__fmaf_rn(px, kInv255, -mean[ch]), stdev[ch]);
  }
  store_from_f32(out + idx, v);
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

int mercury_table_refresh_draw(const void* table, const void* slots, const void* rscores,
                               const void* ema, const void* uniforms, float alpha,
                               float decay, int n, int r, int b, void* new_table,
                               void* probs, void* cdf, void* selected, void* scaled,
                               void* stream) {
  table_refresh_draw_kernel<<<1, kDrawThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int64_t*>(slots),
      static_cast<const float*>(rscores), static_cast<const float*>(ema),
      static_cast<const float*>(uniforms), alpha, decay, n, r, b,
      static_cast<float*>(new_table), static_cast<float*>(probs),
      static_cast<float*>(cdf), static_cast<int32_t*>(selected),
      static_cast<float*>(scaled));
  return static_cast<int>(cudaGetLastError());
}

// dtype of out: 0 = float32, 1 = bfloat16.
int mercury_augment_normalize(const void* raw, const void* mean, const void* stdev,
                              const void* crop, const void* flip, void* out, int n, int h,
                              int w, int c, int pad, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int64_t total = static_cast<int64_t>(n) * h * w * c;
  const unsigned blocks = static_cast<unsigned>((total + kPixelThreads - 1) / kPixelThreads);
  auto u8 = static_cast<const uint8_t*>(raw);
  auto m = static_cast<const float*>(mean);
  auto sd = static_cast<const float*>(stdev);
  auto cr = static_cast<const int32_t*>(crop);
  auto fl = static_cast<const uint8_t*>(flip);
  if (dtype == 0) {
    augment_normalize_kernel<float><<<blocks, kPixelThreads, 0, st>>>(
        u8, m, sd, cr, fl, static_cast<float*>(out), n, h, w, c, pad);
  } else if (dtype == 1) {
    augment_normalize_kernel<__nv_bfloat16><<<blocks, kPixelThreads, 0, st>>>(
        u8, m, sd, cr, fl, static_cast<__nv_bfloat16*>(out), n, h, w, c, pad);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
