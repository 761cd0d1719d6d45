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
//    step's [320,10] and [32,10] that is ~15 KB and ~1.5 KB, so latency sets
//    the time: the launch and the chain of dependent steps in a row. The
//    earlier design gave a row a warp (22 of 32 lanes idle at C = 10) and
//    read it three times (max, Σexp, the label's logit), each pass ending in
//    a 5-step shuffle reduction. Now a row has G lanes, a power of two up to
//    32 chosen from C by nll_geometry() in ops/mercury_kernels.py: the
//    fewest that leave a lane at most two loads (G = 4 at C = 10, 16 at
//    C = 100), 128 threads a block, from a sweep on the card (PERF.md §6;
//    one lane a row was 0.2 µs slower at C = 10, and staging a block's rows
//    in shared memory with 16-byte loads slower at every shape). Lane g of
//    a row takes the row's vectors g, g + G, ... of V values each, the
//    widest load the row stride and the pointer allow (float2 for 40-byte
//    f32 rows, bf16 pairs for 20-byte bf16 rows), and holds them in
//    registers: the row is read once, in one round trip that overlaps the
//    label's load. Over the registers the lane takes its max and,
//    after log2(G) shuffle steps for the row max (none at G = 1), its sum of
//    exp(z - max) and the label's logit; one more set of log2(G) steps sums
//    both. The label is compared with the column index, never used as an
//    address. The row's first lane writes its loss, so neighbouring rows'
//    losses leave from neighbouring lanes. A lane holds up to 8 vectors; a
//    longer share of the row (C above 256·V) is walked in chunks of 8 twice,
//    once for the max and once for the sum. expf and logf keep their
//    precise forms.
// 2. nll_bwd  — replaces _vjp_bwd / _nll_bwd_kernel (:94-139).
//    grad_ij = (softmax(z_i)_j - [j == y_i])·g_i, computed in float32 and
//    rounded once into the logits' dtype.
//    Bound: bytes (N·C logits read, N·C gradients written, N labels and
//    N g_i read): ~3 KB at the step's [32,10], so latency sets the time, as
//    for nll_fwd, and the layout keeps the chain of dependent steps short:
//    one read of the row, one exp, two short butterflies. It has
//    nll_fwd's layout: G lanes a row, threads and vec from nll_geometry()
//    (G = 4 at C = 10, 16 at C = 100, 128 threads a block), with vec the
//    widest load that both the logits' and the gradient's pointers allow.
//    At entry a lane loads the label, g_i and its vectors g, g + G, ...
//    into registers, all in one round trip. It takes its max, log2(G)
//    shuffle steps give the row max, and each held value becomes
//    e = exp(z - max) in place: expf once an element. Its sum of e and
//    log2(G) more steps give the row's Σe, in float64 and rounded once:
//    the correctly rounded sum, the same for every G and order of adds.
//    (The plain version's float32 sum, in ATen's order, can be an ulp off
//    it in some rows; a bf16 gradient near a rounding midpoint then rounds
//    the other way, one bf16 ulp.) The gradient comes from the
//    registers, (e / Σe - [col == y])·g_i with a true division, and each
//    lane writes its vectors at the width of its loads (__stcg, one
//    STG.E.64 / STG.E.128), neighbouring lanes on neighbouring addresses.
//    A lane holds up to 8 vectors; a longer share of the row is walked in
//    chunks of 8 three times (max, sum, then the gradient with the
//    exponentials computed again).
// 3. score_and_draw — replaces score_and_draw_pallas / _score_draw_kernel /
//    _inverse_cdf_draw (:146-302).
//    s = max(loss + a·ema, 1e-12), p = s/Σs, cdf = inclusive scan of p,
//    idx_b = min(#{j : cdf_j <= u_b}, N-1), scaled_b = p[idx_b]·N.
//    Bound: bytes (N losses read, N probs written, 12B more); at N = 320
//    that is a nanosecond and the launch sets the time.
// 4. table_refresh_draw — replaces table_refresh_draw_pallas /
//    _table_refresh_draw_kernel (:306-423).
//    t_i = mu + (t_i - mu)·decay for every slot; each refresh slot s then
//    takes the mean of the R refresh scores aimed at it (duplicates
//    averaged, summed in index order); then score_and_draw's normalize,
//    scan and draw over the whole table, with scaled_b = p[idx_b]·L.
//    Bound: bytes (L read, 2L written: the new table and probs; 12R + 12B
//    more); launch-bound at L = 5000.
//
//    Both run on select_kernel, one launch each. The sum, the scan and the
//    draws need the whole array, so the earlier design was one block of
//    1024 threads on one SM of 132: it walked the array in 1024-wide tiles
//    with a running carry (49 tiles in series at 50,000, three barriers
//    each), read every value twice, wrote the decayed table and read it
//    back, and wrote the whole cdf to device memory for the B binary
//    searches to read. That cost ~35 µs at 50,000, no faster than the
//    plain op chain.
//    Now the grid is one thread-block cluster of K blocks, so K SMs share
//    the work and exchange through distributed shared memory. K and the
//    rest of the geometry come from draw_geometry() in
//    ops/mercury_kernels.py: one block up to 8192 elements (no cluster
//    barrier, no distributed shared memory), then about 4096 elements a
//    block up to K = 16, a non-portable cluster size the card is asked for
//    first (mercury_cluster_limit; 8 is portable). Block k owns a
//    contiguous range, thread t of it a contiguous run of 8 elements
//    (up to 16 where a block would need more than 1024 threads), held in
//    registers: read once, as float4 where aligned; the table decayed and
//    refreshed there and written once. Over the registers: the score sum (a
//    block reduction; each block stores its sum into every block's shared
//    memory and one cluster barrier publishes them, so each adds the K sums
//    in rank order and Σs is bit-identical in every block and from run to
//    run; no atomics), p = s/Σs (probs written once, and staged in shared
//    memory) with the per-run sums of p, and a block scan of those sums. A
//    draw needs no cdf in memory: block k's cdf starts at P_{k-1}/Σs, P the
//    rank-ordered prefix of the block sums, so the owner block comes from
//    the K - 1 starts every block holds; the owner run from the runs'
//    inclusive prefix in shared memory; the walk over that run's staged
//    probs ends it. A u past the last block's end clamps to n - 1. The one
//    exchange of the block sums replaces a second one of the blocks' totals
//    of p: the one kept measured 0.8 µs at K = 16 (PERF.md §6). The
//    division p = s/Σs is one reciprocal and two fmas an element
//    (quotient()), the correctly rounded quotient by a shorter sequence.
//    Above 262,144 elements a thread takes several runs of 8, one a tile,
//    and each pass reads them again from device memory: runs of 8 keep a
//    warp's float4 loads on 8 lines (a run of 64 put them on 32, and was
//    slower than the plain chain at 10^6). The prefix over all the block's
//    runs stays in shared memory; past 32,768 runs a block, runs grow.
//    The table's refresh entries are staged in shared memory; the entry
//    whose slot lies in a block's range puts the slot's mean, summed in
//    index order, where the owner thread picks it up.
//    The float sums run in another order than the TPU kernel's chunked
//    matmul prefix and the plain version's cumsum, so a u_b within ~1e-6
//    of a cdf value can land one index over; tests and chip_smoke.py count
//    such u and require equal indices outside that band, and every draw to
//    satisfy cdf64[idx-1] - δ <= u < cdf64[idx] + δ. The true n is used,
//    with no padding (the TPU wrapper pads awkward sizes for Mosaic only).
// 5. augment_normalize — replaces augment_normalize_pallas /
//    _augment_norm_kernel (:427-551).
//    out[i,y,x,c] = (fma(u8, RN(1/255), -mean_c) / std_c) at the source
//    pixel (y + oy - pad, (flip ? W-1-x : x) + ox - pad) of image rows[i]
//    (image i without rows), +0.0 outside the image, cast to f32 or bf16
//    as the last op. The arithmetic is the TPU kernel's as XLA compiles
//    it: the division by the constant 255 is a multiply by its rounded
//    reciprocal fused with the subtraction of the mean; the division by
//    std is a true division. The intrinsics spell out each rounding, so
//    nvcc's -fmad contraction cannot change a bit and the output equals
//    the plain version's exactly.
//    Bound: bytes (N·H·W·C bytes read, 4 or 2 times that written). The
//    earlier design, a thread per output element with four 64-bit
//    divisions and a true division each, was bound by instructions
//    (7.8 µs at [320] against a 1.5 µs bound). Now a block takes a band
//    of output rows of one image (ingest_geometry() in
//    ops/mercury_kernels.py; the whole image by default). It stages the
//    source rows any offset in [0, 2·pad] can reach, band ± pad, in
//    shared memory once: one bulk async copy completing on an mbarrier
//    where a row is a multiple of 16 bytes (16-byte loads measured no
//    faster), byte loads otherwise. While the bytes are in flight it
//    builds a table of the C·256 normalized values T[c][v] with the
//    arithmetic above, so every output element is a lookup, bit-equal by
//    construction, and the only divisions are the table's. H = W = 32,
//    C = 3 is a template specialization: a thread looks up whole pixels,
//    so channels and table rows are constants, into the band's output in
//    shared memory, which the block then writes with 16-byte stores,
//    neighbouring threads on neighbouring addresses; an output row whose
//    source row lies in the padding is zeros without lookups. Any other
//    shape is written a pixel a thread. With rows the launch gathers the
//    images itself (no separate x[rows] launch); a row outside [0, M) or
//    an offset outside [0, 2·pad] traps.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNllChunk = 8;       // most vectors an NLL lane holds in registers
constexpr int kNllThreads = 256;   // most threads of an NLL block
constexpr int kDrawThreads = 1024;  // most threads of a selection block
constexpr int kDrawWarps = kDrawThreads / kWarp;
constexpr int kRegRun = 16;         // longest run a thread holds in registers
constexpr int kMaxCluster = 16;     // 8 is portable; 16 needs the non-portable attribute
// A signaling NaN: no arithmetic result has this bit pattern (NaN results
// are the canonical quiet NaN), so it marks an element no refresh mean was
// put at.
constexpr unsigned kUnset = 0x7fa5a5a5u;
constexpr float kInv255 = 0x1.010102p-8f;  // 1/255 rounded to float32
constexpr int kIngestThreads = 1024;       // most threads of an ingest block
constexpr int kLevels = 256;               // table entries of a channel: every uint8 value
constexpr int kByteLoads = 16;             // byte loads a thread keeps in flight
// How an ingest block stages its source rows (the geometry's `copy`).
constexpr int kCopyBytes = 0;  // byte loads: any shape
constexpr int kCopyBulk = 1;   // one bulk async copy on an mbarrier: rows of a multiple of
                               // 16 bytes, raw 16-byte aligned

__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// An unsigned type of kBytes bytes, for one load or store of a vector.
template <int kBytes> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// V values of type T at p (aligned to their size) as float32, in one load
// through the read-only path.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  constexpr int kBytes = V * static_cast<int>(sizeof(T));
  using R = typename Raw<kBytes>::type;
  const R r = __ldg(reinterpret_cast<const R*>(p));
  if constexpr (kBytes == 2) {
    v[0] = __uint_as_float(static_cast<unsigned>(r) << 16);
  } else {
    unsigned w[kBytes / 4];
    memcpy(w, &r, kBytes);
#pragma unroll
    for (int i = 0; i < kBytes / 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        v[i] = __uint_as_float(w[i]);
      } else {  // two bf16, the first in the low half
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
}

// V float32 values at p (aligned to their size), each rounded once into T
// by store_from_f32, in one store through L2: __stcg on the raw vector
// compiles to one STG.E.64 / STG.E.128, where a plain float4 store was four
// STG.E in the ingest kernel.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  constexpr int kBytes = V * static_cast<int>(sizeof(T));
  using R = typename Raw<kBytes>::type;
  T t[V];
#pragma unroll
  for (int e = 0; e < V; ++e) store_from_f32(t + e, v[e]);
  R r;
  memcpy(&r, t, kBytes);
  __stcg(reinterpret_cast<R*>(p), r);
}

// The K vectors first, first + lanes, ... of a row of nvec vectors; -inf
// past its end (no term of the max).
template <typename T, int V, int K>
__device__ __forceinline__ void load_vectors(const T* z, int first, int lanes, int nvec,
                                             float* v) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = first + k * lanes;
    if (j < nvec) {
      load_vec<T, V>(z + j * V, v + k * V);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[k * V + e] = -INFINITY;
    }
  }
}

template <int N>
__device__ __forceinline__ float max_of(const float* v, float m) {
#pragma unroll
  for (int i = 0; i < N; ++i) m = fmaxf(m, v[i]);
  return m;
}

// The max and the sum across the G lanes of a row: log2(G) xor-shuffle
// steps (none at G = 1). Every lane of the warp takes part, those of rows
// past N too.
__device__ __forceinline__ float lanes_max(float m, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o, lanes));
  return m;
}

template <typename F>
__device__ __forceinline__ F lanes_sum(F s, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o, lanes);
  return s;
}

// s += exp(v - m) over the K vectors from vector `first` (stride lanes)
// that lie in the row, and the logit of column y where one of them holds it.
template <int V, int K>
__device__ __forceinline__ void add_exps(const float* v, float m, int first, int lanes, int nvec,
                                         int y, float* s, float* picked) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = first + k * lanes;
    if (j < nvec) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float x = v[k * V + e];
        *s += expf(x - m);
        if (j * V + e == y) *picked = x;
      }
    }
  }
}

// Rows of [N, C] logits, G = lanes a row (a power of two ≤ 32), blockDim.x / G
// rows a block. V values a load; kHeld vectors a lane holds in registers
// (1, 2, 4 or 8), or 0: the lane's share is walked in chunks of kNllChunk,
// twice.
template <typename T, int V, int kHeld>
__global__ void __launch_bounds__(kNllThreads)
nll_fwd_kernel(const T* __restrict__ logits, const int32_t* __restrict__ labels,
               float* __restrict__ out, int n, int c, int lanes) {
  const int shift = __ffs(lanes) - 1;
  const int rows = blockDim.x >> shift;
  const int row = blockIdx.x * rows + (threadIdx.x >> shift);
  const int g = threadIdx.x & (lanes - 1);
  const bool live = row < n;  // dead lanes still take part in the shuffles
  // The label is compared with the column index, never used as an address:
  // a label outside [0, C) picks nothing and the loss is the logsumexp.
  int y = live ? __ldg(labels + row) : -1;
  if (y >= c) y = -1;
  const int nvec = live ? c / V : 0;
  const T* z = logits + static_cast<size_t>(row) * c;
  float m = -INFINITY, s = 0.f, picked = 0.f;
  if constexpr (kHeld > 0) {
    float v[kHeld * V];
    load_vectors<T, V, kHeld>(z, g, lanes, nvec, v);
    m = lanes_max(max_of<kHeld * V>(v, m), lanes);
    add_exps<V, kHeld>(v, m, g, lanes, nvec, y, &s, &picked);
  } else {
    float v[kNllChunk * V];
    const int step = kNllChunk * lanes;
    for (int first = g; first < nvec; first += step) {
      load_vectors<T, V, kNllChunk>(z, first, lanes, nvec, v);
      m = max_of<kNllChunk * V>(v, m);
    }
    m = lanes_max(m, lanes);
    for (int first = g; first < nvec; first += step) {
      load_vectors<T, V, kNllChunk>(z, first, lanes, nvec, v);
      add_exps<V, kNllChunk>(v, m, first, lanes, nvec, y, &s, &picked);
    }
  }
  // One combine: the picked logit rides in the sum's shuffle rounds (only
  // one lane holds it; the others add 0).
  for (int o = lanes >> 1; o > 0; o >>= 1) {
    s += __shfl_xor_sync(kFull, s, o, lanes);
    picked += __shfl_xor_sync(kFull, picked, o, lanes);
  }
  if (live && g == 0) out[row] = (logf(s) + m) - picked;
}

// e = exp(v - m) in place over the K vectors from vector `first` (stride
// lanes) that lie in the row; with kSum, each e also added to the float64
// *s in register order.
template <int V, int K, bool kSum>
__device__ __forceinline__ void exps_in_place(float* v, float m, int first, int lanes,
                                              int nvec, double* s) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (first + k * lanes < nvec) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        v[k * V + e] = expf(v[k * V + e] - m);
        if constexpr (kSum) *s += v[k * V + e];
      }
    }
  }
}

// The gradient (e / s - [col == y])·gi of the K vectors from vector `first`
// (stride lanes) that lie in the row, e held in registers; one store of V
// values each.
template <typename T, int V, int K>
__device__ __forceinline__ void store_grads(T* out, const float* e, float s, int y, float gi,
                                            int first, int lanes, int nvec) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = first + k * lanes;
    if (j < nvec) {
      float r[V];
#pragma unroll
      for (int i = 0; i < V; ++i) r[i] = (e[k * V + i] / s - (j * V + i == y ? 1.f : 0.f)) * gi;
      store_vec<T, V>(out + j * V, r);
    }
  }
}

// The gradient of the per-sample NLL (kernel 2 of the header) with
// nll_fwd_kernel's layout: G lanes a row, V values a load and a store,
// kHeld vectors a lane (1, 2, 4 or 8) held in registers, or 0: the share
// walked in chunks of kNllChunk three times. Σe is summed in float64 and
// rounded once: the correctly rounded sum in any order of adds, so the
// gradient does not depend on G.
template <typename T, int V, int kHeld>
__global__ void __launch_bounds__(kNllThreads)
nll_bwd_kernel(const T* __restrict__ logits, const int32_t* __restrict__ labels,
               const float* __restrict__ g, T* __restrict__ grad, int n, int c, int lanes) {
  const int shift = __ffs(lanes) - 1;
  const int row = blockIdx.x * (blockDim.x >> shift) + (threadIdx.x >> shift);
  const int lane = threadIdx.x & (lanes - 1);
  const bool in_rows = row < n;  // lanes past N run on: only memory is guarded
  // As in nll_fwd_kernel, a label outside [0, C) matches no column: it
  // subtracts nothing.
  int y = in_rows ? __ldg(labels + row) : -1;
  if (y >= c) y = -1;
  const float gi = in_rows ? __ldg(g + row) : 0.f;
  const int nvec = in_rows ? c / V : 0;
  const size_t off = static_cast<size_t>(row) * c;
  const T* z = logits + off;
  T* out = grad + off;
  float m = -INFINITY;
  double s = 0.0;
  if constexpr (kHeld > 0) {
    float v[kHeld * V];
    load_vectors<T, V, kHeld>(z, lane, lanes, nvec, v);
    m = lanes_max(max_of<kHeld * V>(v, m), lanes);
    exps_in_place<V, kHeld, true>(v, m, lane, lanes, nvec, &s);
    const float sum = static_cast<float>(lanes_sum(s, lanes));
    store_grads<T, V, kHeld>(out, v, sum, y, gi, lane, lanes, nvec);
  } else {
    float v[kNllChunk * V];
    const int step = kNllChunk * lanes;
    for (int first = lane; first < nvec; first += step) {
      load_vectors<T, V, kNllChunk>(z, first, lanes, nvec, v);
      m = max_of<kNllChunk * V>(v, m);
    }
    m = lanes_max(m, lanes);
    for (int first = lane; first < nvec; first += step) {
      load_vectors<T, V, kNllChunk>(z, first, lanes, nvec, v);
      exps_in_place<V, kNllChunk, true>(v, m, first, lanes, nvec, &s);
    }
    const float sum = static_cast<float>(lanes_sum(s, lanes));
    for (int first = lane; first < nvec; first += step) {
      load_vectors<T, V, kNllChunk>(z, first, lanes, nvec, v);
      exps_in_place<V, kNllChunk, false>(v, m, first, lanes, nvec, nullptr);
      store_grads<T, V, kNllChunk>(out, v, sum, y, gi, first, lanes, nvec);
    }
  }
}

// Smoothed, floored score; `a` is alpha·ema rounded once, as in the plain
// version (kept apart from the add so nothing contracts it into an fma).
__device__ __forceinline__ float score_of(float loss, float a) {
  return fmaxf(__fadd_rn(loss, a), 1e-12f);
}

// a/b correctly rounded, from inv = RN(1/b): q = RN(a·inv) is within an ulp,
// the residual a - b·q is exact in an fma, and one more fma step rounds to
// RN(a/b) (Markstein) while a, b and the quotient stay normal, as scores in
// [1e-12, 3e38] over their sum do. It is the result of a true division
// without its longer instruction sequence per element (a CPU test checks
// the step with exact rationals).
__device__ __forceinline__ float quotient(float a, float b, float inv) {
  const float q = __fmul_rn(a, inv);
  return __fmaf_rn(__fmaf_rn(-q, b, a), inv, q);
}

// Decay toward the EMA mean, each rounding spelled out (no fma).
__device__ __forceinline__ float decayed(float t, float mu, float decay) {
  return __fadd_rn(mu, __fmul_rn(__fsub_rn(t, mu), decay));
}

// Arguments of select_kernel. vals is the pool's losses or the table before
// the decay; slots, rscores and new_table belong to the table only. The
// geometry (per_block, run; K and the block size are the launch's) comes
// from draw_geometry() in ops/mercury_kernels.py.
struct DrawArgs {
  const float* vals;
  const float* ema;
  const float* uniforms;
  const int64_t* slots;
  const float* rscores;
  float alpha, decay;
  int n, r, b, per_block, run;
  float* new_table;
  float* probs;
  int32_t* selected;
  float* scaled;
};

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// A run of cnt <= kRegRun values into registers; as float4 when vec (cnt a
// multiple of 4, p 16-byte aligned).
__device__ __forceinline__ void load_run(const float* p, int cnt, bool vec,
                                         float (&v)[kRegRun]) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < kRegRun / 4; ++q) {
      if (4 * q < cnt) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(p) + q);
        v[4 * q] = x.x;
        v[4 * q + 1] = x.y;
        v[4 * q + 2] = x.z;
        v[4 * q + 3] = x.w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kRegRun; ++j)
      if (j < cnt) v[j] = __ldg(p + j);
  }
}

// A run of cnt <= kRegRun values from shared memory into registers.
__device__ __forceinline__ void load_shared_run(const float* p, int cnt, bool vec,
                                                float (&v)[kRegRun]) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < kRegRun / 4; ++q) {
      if (4 * q < cnt) {
        const float4 x = reinterpret_cast<const float4*>(p)[q];
        v[4 * q] = x.x;
        v[4 * q + 1] = x.y;
        v[4 * q + 2] = x.z;
        v[4 * q + 3] = x.w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kRegRun; ++j)
      if (j < cnt) v[j] = p[j];
  }
}

__device__ __forceinline__ void store_run(float* p, int cnt, bool vec,
                                          const float (&v)[kRegRun]) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < kRegRun / 4; ++q)
      if (4 * q < cnt)
        reinterpret_cast<float4*>(p)[q] =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < kRegRun; ++j)
      if (j < cnt) p[j] = v[j];
  }
}

// A split cluster barrier: every thread arrives at kernel entry and waits
// just before the first store into another block's shared memory, which
// may be made only once that block has started. By then every block has
// arrived, so the wait costs next to nothing.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// Normalize and draw over the whole array, as one cluster of gridDim.x
// blocks (kCluster) or one block. kTable: decay and refresh the table first
// and write it. Block k's range is split into runs of `run` elements, run
// v (its "virtual thread") starting at blo + v·run; thread t takes runs t,
// t + blockDim, ... (the tiles). kRegs: one tile of runs of at most kRegRun,
// held in registers, and the block's probs staged in shared memory for the
// draws. Otherwise each pass reads the thread's runs again from device
// memory; runs of 8 keep a warp's loads dense.
// Dynamic shared memory, in order: incl[tiles·blockDim] (the inclusive
// prefix of p over the runs); for kRegs sp[per_block] (first the refresh
// means at their elements, kUnset elsewhere, then the block's probs);
// wtot[tiles·warps] (each warp's total in each tile); for the table
// slots[r] (as int, -1 for a slot outside [0, n)) and rscores[r].
template <bool kTable, bool kCluster, bool kRegs>
__global__ void __launch_bounds__(kDrawThreads) select_kernel(const DrawArgs a) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ float warp_sums[kDrawWarps];
  __shared__ float sums[kMaxCluster];  // S_k, stored here by block k
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads / kWarp;
  const int rank = blockIdx.x;  // the grid is one cluster: block rank = blockIdx.x
  const int nblocks = gridDim.x;
  const int blo = rank * a.per_block;
  const int bhi = min(blo + a.per_block, a.n);
  const int tile = nthreads * a.run;
  const int ntiles = kRegs ? 1 : (a.per_block + tile - 1) / tile;
  const int nruns = ntiles * nthreads;
  const int lo = blo + tid * a.run;  // the first tile's run
  const int cnt = max(0, min(a.run, bhi - lo));
  float* incl = reinterpret_cast<float*>(dyn_smem);
  float* sp = incl + nruns;
  float* wtot = sp + (kRegs ? a.per_block : 0);
  int* ss = reinterpret_cast<int*>(wtot + ntiles * nwarps);
  float* srs = reinterpret_cast<float*>(ss + a.r);
  // A run starts at a multiple of 4 whenever run is (per_block always is).
  const bool vec_run = (a.run & 3) == 0;
  const bool vec_len = (cnt & 3) == 0 && vec_run;
  if constexpr (kCluster) cluster_arrive_relaxed();

  // Every load that needs nothing computed goes out first: the run, the
  // EMA, this thread's first uniform and the refresh window.
  float v[kRegs ? kRegRun : 1];
  if constexpr (kRegs) load_run(a.vals + lo, cnt, vec_len && aligned16(a.vals), v);
  const float mu = __ldg(a.ema);
  float u_next = tid < a.b ? __ldg(a.uniforms + tid) : 0.f;
  const float am = __fmul_rn(a.alpha, mu);
  if constexpr (kTable) {
    if constexpr (kRegs) {
      float unset[kRegRun];
#pragma unroll
      for (int j = 0; j < kRegRun; ++j) unset[j] = __uint_as_float(kUnset);
      store_run(sp + (lo - blo), cnt, vec_len, unset);
    }
    for (int k = tid; k < a.r; k += nthreads) {
      const int64_t slot = __ldg(a.slots + k);
      ss[k] = slot >= 0 && slot < a.n ? static_cast<int>(slot) : -1;  // -1: in no range
      srs[k] = __ldg(a.rscores + k);
    }
    if constexpr (!kRegs) {
      // Runs in device memory: decay into new_table first; the refresh
      // means overwrite their slots after the barrier below.
      for (int i = 0; i < ntiles; ++i) {
        const int rlo = lo + i * tile;
        const int rcnt = max(0, min(a.run, bhi - rlo));
        if ((rcnt & 3) == 0 && vec_run && aligned16(a.vals) && aligned16(a.new_table)) {
          for (int j = 0; j < rcnt; j += 4) {
            const float4 x = __ldg(reinterpret_cast<const float4*>(a.vals + rlo + j));
            *reinterpret_cast<float4*>(a.new_table + rlo + j) =
                make_float4(decayed(x.x, mu, a.decay), decayed(x.y, mu, a.decay),
                            decayed(x.z, mu, a.decay), decayed(x.w, mu, a.decay));
          }
        } else {
          for (int j = 0; j < rcnt; ++j)
            a.new_table[rlo + j] = decayed(__ldg(a.vals + rlo + j), mu, a.decay);
        }
      }
    }
    __syncthreads();
    // The refresh window, a thread per entry: an entry whose slot lies in
    // this block's range takes the mean of every refresh score aimed at the
    // slot, summed in index order (as the plain version), and puts it at
    // the slot; the entries of one slot put the same value. A slot outside
    // [0, L) lies in no block's range and is never an address.
    for (int k = tid; k < a.r; k += nthreads) {
      const int s = ss[k];
      if (s < blo || s >= bhi) continue;
      // Count the entries of this slot first (no float chain), and sum
      // their scores in index order only when there are several: a lone
      // entry's mean (0 + x)/1 is 0 + x.
      int count = 0;
#pragma unroll 16
      for (int j = 0; j < a.r; ++j) count += ss[j] == s;
      float mean = __fadd_rn(0.f, srs[k]);
      if (count > 1) {
        float sum = 0.f;
        for (int j = 0; j < a.r; ++j)
          if (ss[j] == s) sum = __fadd_rn(sum, srs[j]);
        mean = __fdiv_rn(sum, static_cast<float>(count));
      }
      if constexpr (kRegs) {
        sp[s - blo] = mean;
      } else {
        a.new_table[s] = mean;
      }
    }
    __syncthreads();
  }

  // Pass 1: the values (decayed and refreshed for the table, written once)
  // and the thread's sum of their scores, in index order.
  const float* src = kTable ? a.new_table : a.vals;  // the runs in device memory
  float local = 0.f;
  if constexpr (kRegs) {
    if constexpr (kTable) {
      float put[kRegRun];
      load_shared_run(sp + (lo - blo), cnt, vec_len, put);
#pragma unroll
      for (int j = 0; j < kRegRun; ++j) {
        if (j < cnt)
          v[j] = __float_as_uint(put[j]) != kUnset ? put[j] : decayed(v[j], mu, a.decay);
      }
      store_run(a.new_table + lo, cnt, vec_len && aligned16(a.new_table), v);
    }
#pragma unroll
    for (int j = 0; j < kRegRun; ++j) {
      if (j < cnt) {
        v[j] = score_of(v[j], am);
        local = __fadd_rn(local, v[j]);
      }
    }
  } else {
    for (int i = 0; i < ntiles; ++i) {
      const int rlo = lo + i * tile;
      const int rcnt = max(0, min(a.run, bhi - rlo));
      if ((rcnt & 3) == 0 && vec_run && aligned16(src)) {
        for (int j = 0; j < rcnt; j += 4) {
          const float4 x = *reinterpret_cast<const float4*>(src + rlo + j);
          local = __fadd_rn(local, score_of(x.x, am));
          local = __fadd_rn(local, score_of(x.y, am));
          local = __fadd_rn(local, score_of(x.z, am));
          local = __fadd_rn(local, score_of(x.w, am));
        }
      } else {
        for (int j = 0; j < rcnt; ++j) local = __fadd_rn(local, score_of(src[rlo + j], am));
      }
    }
  }

  // Σs: a block reduction whose every warp computes the same block sum
  // (the xor butterfly leaves the same bits in every lane). In a cluster,
  // block k stores its sum S_k into sums[k] of every block through
  // distributed shared memory, and one cluster barrier (release, acquire)
  // publishes them; each block then adds S_0..S_{K-1} in rank order, so Σs
  // is bit-identical in every block, and keeps the inclusive prefix P_q in
  // lane q. No block touches another's shared memory after the barrier,
  // so none need wait for the others before it exits. The one exchange
  // replaces a second one of the blocks' totals of p (PERF.md §6).
  local = warp_sum(local);
  if (lane == 0) warp_sums[warp] = local;
  __syncthreads();
  const float bsum = warp_sum(lane < nwarps ? warp_sums[lane] : 0.f);
  float total = bsum;
  float prefix = 0.f;     // P_{rank-1}: Σs of the blocks before this one
  float lane_cum = bsum;  // lane q: P_q
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster_wait();  // every block has started
    if (warp == 0 && lane < nblocks) *cluster.map_shared_rank(&sums[rank], lane) = bsum;
    cluster.sync();
    const float mine = lane < nblocks ? sums[lane] : 0.f;
    total = 0.f;
    for (int k = 0; k < nblocks; ++k) {
      if (k == rank) prefix = total;
      total = __fadd_rn(total, __shfl_sync(kFull, mine, k));
      if (lane == k) lane_cum = total;
    }
  }

  // Pass 2: p = s/Σs, written once (and staged in shared memory for the
  // draws), the sum of p over each of the thread's runs, and its warp scan
  // (the run's prefix within its warp) into incl, each warp's total into
  // wtot.
  const float inv = __frcp_rn(total);
  auto warp_scan_run = [&](int i, float mass) {
    for (int o = 1; o < kWarp; o <<= 1) {
      const float y = __shfl_up_sync(kFull, mass, o);
      if (lane >= o) mass += y;
    }
    incl[i * nthreads + tid] = mass;
    if (lane == kWarp - 1) wtot[i * nwarps + warp] = mass;
  };
  if constexpr (kRegs) {
    float mass = 0.f;
#pragma unroll
    for (int j = 0; j < kRegRun; ++j) {
      if (j < cnt) {
        v[j] = quotient(v[j], total, inv);
        mass = __fadd_rn(mass, v[j]);
      }
    }
    store_run(a.probs + lo, cnt, vec_len && aligned16(a.probs), v);
    store_run(sp + (lo - blo), cnt, vec_len, v);
    warp_scan_run(0, mass);
  } else {
    for (int i = 0; i < ntiles; ++i) {
      const int rlo = lo + i * tile;
      const int rcnt = max(0, min(a.run, bhi - rlo));
      float mass = 0.f;
      if ((rcnt & 3) == 0 && vec_run && aligned16(src) && aligned16(a.probs)) {
        for (int j = 0; j < rcnt; j += 4) {
          const float4 x = *reinterpret_cast<const float4*>(src + rlo + j);
          const float4 p = make_float4(
              quotient(score_of(x.x, am), total, inv), quotient(score_of(x.y, am), total, inv),
              quotient(score_of(x.z, am), total, inv), quotient(score_of(x.w, am), total, inv));
          *reinterpret_cast<float4*>(a.probs + rlo + j) = p;
          mass = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(mass, p.x), p.y), p.z), p.w);
        }
      } else {
        for (int j = 0; j < rcnt; ++j) {
          const float p = quotient(score_of(src[rlo + j], am), total, inv);
          a.probs[rlo + j] = p;
          mass = __fadd_rn(mass, p);
        }
      }
      warp_scan_run(i, mass);
    }
  }
  __syncthreads();

  // The prefix over all runs of the block, tile after tile: each warp scans
  // the tile's warp totals, adds the one before it to its runs' in-warp
  // prefixes, and the tile's offset. A tile's mass is its last run's prefix,
  // formed the same way, so the block's mass equals the last prefix bit for
  // bit and the block and run levels of the draw agree on it.
  float bmass = 0.f;
  for (int i = 0; i < ntiles; ++i) {
    float w = lane < nwarps ? wtot[i * nwarps + lane] : 0.f;
    const float last_warp = __shfl_sync(kFull, w, nwarps - 1);
    for (int o = 1; o < kWarp; o <<= 1) {
      const float y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    const float before = __shfl_sync(kFull, w, max(warp - 1, 0));
    const float before_last = __shfl_sync(kFull, w, max(nwarps - 2, 0));
    const float x = incl[i * nthreads + tid];
    const float in_tile = warp > 0 ? __fadd_rn(before, x) : x;
    const float tile_mass = nwarps > 1 ? __fadd_rn(before_last, last_warp) : last_warp;
    incl[i * nthreads + tid] = i > 0 ? __fadd_rn(bmass, in_tile) : in_tile;
    bmass = i > 0 ? __fadd_rn(bmass, tile_mass) : tile_mass;
  }

  // The block boundaries of the cdf: block k starts at off_k = P_{k-1}/Σs
  // (lane q holds C_q = P_q/Σs, the start of block q + 1), and within it
  // the cdf is off_k + the prefix of p. The two agree to rounding, so a u
  // that falls between a block's last running sum and the next block's
  // start, within ~1e-7, draws the block's last element.
  const float off = quotient(prefix, total, inv);
  const float cum = quotient(lane_cum, total, inv);
  const float end = __fadd_rn(off, bmass);  // where this block's cdf ends
  __syncthreads();  // incl[], sp and probs are complete

  // The draws; thread tid takes uniforms tid, tid + blockDim, ... The owner
  // block is the number of block starts C_0..C_{K-2} at or below u; its
  // owner run the first r with off + incl[r] > u; the index in that run is
  // the number of its running sums <= u (the sums rise, so this is the
  // first one above u), at most the run's last. A u at or past the last
  // block's end clamps to n - 1.
  for (int base = warp * kWarp; base < a.b; base += nthreads) {
    const int k = base + lane;
    const float u = u_next;
    if (base + nthreads < a.b) u_next = k + nthreads < a.b ? __ldg(a.uniforms + k + nthreads) : 0.f;
    int owner = 0;
    for (int q = 0; q + 1 < nblocks; ++q) owner += __shfl_sync(kFull, cum, q) <= u ? 1 : 0;
    if (k >= a.b || owner != rank) continue;
    int idx;
    if (rank == nblocks - 1 && u >= end) {
      idx = a.n - 1;
    } else {
      int l = 0, h = nruns;
      while (l < h) {
        const int mid = (l + h) >> 1;
        if (__fadd_rn(off, incl[mid]) <= u) l = mid + 1; else h = mid;
      }
      const int run = min(l, nruns - 1);
      const int rlo = blo + run * a.run;
      const int rcnt = max(0, min(a.run, bhi - rlo));
      const float* rp = kRegs ? sp + (rlo - blo) : a.probs + rlo;
      float c = run > 0 ? __fadd_rn(off, incl[run - 1]) : off;
      int below = 0;
      if (!kRegs && (rcnt & 3) == 0 && vec_run && aligned16(rp)) {
        for (int j = 0; j < rcnt; j += 4) {
          const float4 p = *reinterpret_cast<const float4*>(rp + j);
          c = __fadd_rn(c, p.x);
          below += c <= u;
          c = __fadd_rn(c, p.y);
          below += c <= u;
          c = __fadd_rn(c, p.z);
          below += c <= u;
          c = __fadd_rn(c, p.w);
          below += c <= u;
        }
      } else if (kRegs) {
#pragma unroll
        for (int j = 0; j < kRegRun; ++j) {
          if (j < rcnt) {
            c = __fadd_rn(c, rp[j]);
            below += c <= u;
          }
        }
      } else {
        for (int j = 0; j < rcnt; ++j) {
          c = __fadd_rn(c, rp[j]);
          below += c <= u;
        }
      }
      idx = max(min(rlo + min(below, rcnt - 1), bhi - 1), blo);
    }
    a.selected[k] = idx;
    a.scaled[k] = __fmul_rn(kRegs ? sp[idx - blo] : a.probs[idx], static_cast<float>(a.n));
  }
}

using SelectFn = void (*)(DrawArgs);

template <bool kTable>
SelectFn select_fn(bool cluster, bool regs) {
  if (cluster) return regs ? &select_kernel<kTable, true, true> : &select_kernel<kTable, true, false>;
  return regs ? &select_kernel<kTable, false, true> : &select_kernel<kTable, false, false>;
}

// Launches select_kernel as one cluster of `clusters` blocks of `threads`
// (clusters = 1: a plain one-block launch). A geometry that leaves part of
// [0, n) unowned, a last block empty or too little shared memory is
// refused; so is a launch the card refuses. Nothing is allocated and
// nothing synchronized, so the launch can be captured in a CUDA graph.
template <bool kTable>
int launch_select(const DrawArgs& a, int clusters, int threads, int smem, cudaStream_t st) {
  if (threads < kWarp || threads > kDrawThreads || threads % kWarp != 0 || a.run < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = (a.per_block + static_cast<int64_t>(threads) * a.run - 1) /
                        (static_cast<int64_t>(threads) * a.run);
  const bool regs = tiles == 1 && a.run <= kRegRun;
  const int64_t need = 4 * tiles * threads + 4 * tiles * (threads / kWarp) +
                       (regs ? 4LL * a.per_block : 0) + (kTable ? 8LL * a.r : 0);
  const bool ok = clusters >= 1 && clusters <= kMaxCluster && (clusters & (clusters - 1)) == 0 &&
                  a.n >= 1 && a.per_block >= 4 && a.per_block % 4 == 0 &&
                  static_cast<int64_t>(clusters) * a.per_block >= a.n &&
                  static_cast<int64_t>(clusters - 1) * a.per_block < a.n && a.r >= 0 &&
                  a.b >= 0 && smem >= need;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const SelectFn fn = select_fn<kTable>(clusters > 1, regs);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (clusters > 8) {
    const cudaError_t e =
        cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = clusters > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, fn, a);
  if (e != cudaSuccess) {
    (void)cudaGetLastError();  // do not leave it to the next launch's check
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// Arguments of augment_normalize_kernel; the geometry (band; threads and
// shared memory are the launch's) comes from ingest_geometry() in
// ops/mercury_kernels.py.
struct IngestArgs {
  const uint8_t* raw;   // [M, H, W, C]
  const int64_t* rows;  // [N] images of raw to take, or null: image i
  const float* mean;    // [C]
  const float* stdev;   // [C]
  const int32_t* crop;  // [N, 2]: (oy, ox) in [0, 2·pad]
  const uint8_t* flip;  // [N]
  void* out;            // [N, H, W, C] float32 or bfloat16
  int m, h, w, c, pad, band;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: `bytes` (a multiple of 16; both addresses 16-byte aligned)
// from device memory into shared memory as one bulk async copy that
// completes on the mbarrier `bar`, which it initializes for one arrival.
// Other threads wait on `bar` only after a __syncthreads() that follows.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(b), "r"(1) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// Waits for the first phase of `bar` to complete: the bulk copy has landed.
__device__ __forceinline__ void bulk_wait(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "BULK_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n"
      "@!P1 bra BULK_WAIT;\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x, the lower address, is lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes of output: 4 f32, or 8 bf16 each rounded to nearest even.
__device__ __forceinline__ uint4 pack16(const float* v, float) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack16(const float* v, __nv_bfloat16) {
  return make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]),
                    pack_bf16x2(v[6], v[7]));
}

// The shapes with a specialization of augment_normalize_kernel, and its
// output staged in shared memory (ingest_geometry() knows the same list).
__host__ __device__ constexpr bool ingest_specialized(int h, int w, int c) {
  return h == 32 && w == 32 && c == 3;
}

__host__ __device__ constexpr int gcd_int(int a, int b) {
  return b == 0 ? a : gcd_int(b, a % b);
}

// Block (i, k) of the grid (n, bands) writes output rows [k·band, (k+1)·band)
// ∩ [0, H) of image i. kH, kW, kC: the shape at compile time, or 0 to read
// it from the arguments. Dynamic shared memory: the table T[c][v] (C·256
// floats), then the staged source rows.
template <typename T, int kH, int kW, int kC, int kCopy>
__global__ void __launch_bounds__(kIngestThreads) augment_normalize_kernel(const IngestArgs a) {
  extern __shared__ __align__(16) unsigned char ingest_smem[];
  __shared__ uint64_t bar;
  const int h = kH ? kH : a.h;
  const int w = kW ? kW : a.w;
  const int c = kC ? kC : a.c;
  const int row = w * c;  // elements of an image row, and source bytes
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int img = blockIdx.x;
  const int y0 = blockIdx.y * a.band;
  const int y1 = min(y0 + a.band, h);
  // The source rows an offset in [0, 2·pad] can reach from the band.
  const int s0 = max(y0 - a.pad, 0);
  const int s1 = min(y1 + a.pad, h);

  // Every load goes out first: the row (with rows), the offsets, the flip,
  // mean and std; then the source bytes (after the row); the table is built
  // while they fly.
  const int64_t src_img = a.rows != nullptr ? __ldg(a.rows + img) : img;
  const int oy = __ldg(a.crop + 2 * img);
  const int ox = __ldg(a.crop + 2 * img + 1);
  const bool flip = __ldg(a.flip + img) != 0;
  float mu[kC ? kC : 1], sd[kC ? kC : 1];  // the specialized shape's mean and std
  if constexpr (kC != 0) {
#pragma unroll
    for (int ch = 0; ch < kC; ++ch) {
      mu[ch] = __ldg(a.mean + ch);
      sd[ch] = __ldg(a.stdev + ch);
    }
  }
  if (src_img < 0 || src_img >= a.m) __trap();
  const uint8_t* src = a.raw + (src_img * h + s0) * row;
  const int nbytes = (s1 - s0) * row;
  float* table = reinterpret_cast<float*>(ingest_smem);
  uint8_t* stage = ingest_smem + sizeof(float) * kLevels * c;
  if constexpr (kCopy == kCopyBulk) {
    if (tid == 0) bulk_copy(stage, src, nbytes, &bar);
  }
  if constexpr (kC != 0) {
    // Entry v of every channel a thread: C independent divisions.
    for (int v = tid; v < kLevels; v += nthreads) {
#pragma unroll
      for (int ch = 0; ch < kC; ++ch)
        table[ch * kLevels + v] =
            __fdiv_rn(__fmaf_rn(static_cast<float>(v), kInv255, -mu[ch]), sd[ch]);
    }
  } else {
    for (int k = tid; k < c * kLevels; k += nthreads) {
      const int ch = k / kLevels;
      const float v = static_cast<float>(k % kLevels);
      table[k] = __fdiv_rn(__fmaf_rn(v, kInv255, -__ldg(a.mean + ch)), __ldg(a.stdev + ch));
    }
  }
  if constexpr (kCopy == kCopyBytes) {
    for (int k0 = tid; k0 < nbytes; k0 += kByteLoads * nthreads) {
      uint8_t b[kByteLoads];
#pragma unroll
      for (int j = 0; j < kByteLoads; ++j) {
        const int k = k0 + j * nthreads;
        if (k < nbytes) b[j] = __ldg(src + k);
      }
#pragma unroll
      for (int j = 0; j < kByteLoads; ++j) {
        const int k = k0 + j * nthreads;
        if (k < nbytes) stage[k] = b[j];
      }
    }
  }
  // The sync also keeps every thread off the mbarrier until it is set up.
  __syncthreads();
  if (oy < 0 || oy > 2 * a.pad || ox < 0 || ox > 2 * a.pad) __trap();
  if constexpr (kCopy == kCopyBulk) bulk_wait(&bar);

  // The staged source row of output row y; null for a row of the padding.
  auto source_row = [&](int y) -> const uint8_t* {
    const int sy = y + oy - a.pad;
    return sy >= 0 && sy < h ? stage + (sy - s0) * row : nullptr;
  };
  // Output element (x, ch) of the source row staged at srow, +0.0 outside
  // the image. Without a branch, so a thread's lookups go out together.
  auto value = [&](const uint8_t* srow, int x, int ch) {
    const int sx = (flip ? w - 1 - x : x) + ox - a.pad;
    const float t = table[ch * kLevels + srow[min(max(sx, 0), w - 1) * c + ch]];
    return sx >= 0 && sx < w ? t : 0.f;
  };
  T* out = static_cast<T*>(a.out) + (static_cast<int64_t>(img) * h + y0) * row;
  // The specialized shape: a thread takes kUnit whole pixels, kUnit·C values
  // that fill a whole number of 16-byte pieces, so each value's channel and
  // table row are constants and the bounds are tested once a pixel. The
  // pieces go to shared memory in the output's layout, then the block
  // copies its band out with 16-byte stores, neighbouring threads on
  // neighbouring pieces (a thread's own three pieces, 48 bytes apart from
  // the next thread's, were measured slower straight to device memory).
  if constexpr (kH != 0 && ingest_specialized(kH, kW, kC)) {
    constexpr int kVec = 16 / sizeof(T);  // values a 16-byte piece
    constexpr int kUnit = kVec / gcd_int(kC, kVec);
    static_assert(kW % kUnit == 0, "a unit must not straddle a row");
    constexpr int kUnits = kW / kUnit;  // units an output row
    constexpr int kPer = kUnit * kC;
    if (aligned16(a.out)) {
      const int stage_cap = (min(h, a.band + 2 * a.pad) * row + 15) / 16 * 16;
      uint4* obuf = reinterpret_cast<uint4*>(stage + stage_cap);
      const int units = (y1 - y0) * kUnits;
      for (int q = tid; q < units; q += nthreads) {
        const int y = q / kUnits;
        const int x0 = (q - y * kUnits) * kUnit;
        const uint8_t* srow = source_row(y0 + y);
        float v[kPer];
        if (srow == nullptr) {
#pragma unroll
          for (int j = 0; j < kPer; ++j) v[j] = 0.f;
        } else {
#pragma unroll
          for (int d = 0; d < kUnit; ++d) {
            const int x = x0 + d;
            const int sx = (flip ? kW - 1 - x : x) + ox - a.pad;
            const uint8_t* px = srow + min(max(sx, 0), kW - 1) * kC;
#pragma unroll
            for (int ch = 0; ch < kC; ++ch) {
              const float t = table[ch * kLevels + px[ch]];
              v[d * kC + ch] = sx >= 0 && sx < kW ? t : 0.f;
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kPer / kVec; ++j)
          obuf[q * (kPer / kVec) + j] = pack16(v + j * kVec, T{});
      }
      __syncthreads();
      const int pieces = (y1 - y0) * row / kVec;
      for (int k = tid; k < pieces; k += nthreads)
        __stcg(reinterpret_cast<uint4*>(out) + k, obuf[k]);
      return;
    }
  }
  // Any other shape: a pixel (its C values) a thread.
  const int pixels = (y1 - y0) * w;
  for (int p = tid; p < pixels; p += nthreads) {
    const int y = p / w;
    const int x = p - y * w;
    const uint8_t* srow = source_row(y0 + y);
    for (int ch = 0; ch < c; ++ch)
      store_from_f32(out + p * c + ch, srow != nullptr ? value(srow, x, ch) : 0.f);
  }
}

using IngestFn = void (*)(IngestArgs);

template <typename T, int kH, int kW, int kC>
IngestFn ingest_copy_fn(int copy) {
  return copy == kCopyBulk ? &augment_normalize_kernel<T, kH, kW, kC, kCopyBulk>
                           : &augment_normalize_kernel<T, kH, kW, kC, kCopyBytes>;
}

template <typename T>
IngestFn ingest_fn(bool special, int copy) {
  return special ? ingest_copy_fn<T, 32, 32, 3>(copy) : ingest_copy_fn<T, 0, 0, 0>(copy);
}

// The two NLL kernels' instantiations: get<V, kHeld>() of each family.
template <typename T>
struct NllFwd {
  using Value = T;
  using Fn = void (*)(const T*, const int32_t*, float*, int, int, int);
  template <int V, int kHeld>
  static Fn get() { return &nll_fwd_kernel<T, V, kHeld>; }
};

template <typename T>
struct NllBwd {
  using Value = T;
  using Fn = void (*)(const T*, const int32_t*, const float*, T*, int, int, int);
  template <int V, int kHeld>
  static Fn get() { return &nll_bwd_kernel<T, V, kHeld>; }
};

template <class K, int V>
typename K::Fn nll_held_fn(int held) {
  switch (held) {
    case 1: return K::template get<V, 1>();
    case 2: return K::template get<V, 2>();
    case 4: return K::template get<V, 4>();
    case 8: return K::template get<V, 8>();
    default: return K::template get<V, 0>();
  }
}

// The kernel of family K for C values a row, G lanes a row and V values a
// load (a vector of at most 16 bytes dividing C), or null. A lane holds the
// fewest of 1, 2, 4, 8 vectors that take its share, or walks it in chunks of
// kNllChunk (0) past 8.
template <class K>
typename K::Fn nll_fn(int c, int lanes, int vec) {
  if (c % vec != 0) return nullptr;
  const int share = (c / vec + lanes - 1) / lanes;
  const int held = share <= 1 ? 1 : share <= 2 ? 2 : share <= 4 ? 4 : share <= kNllChunk ? 8 : 0;
  switch (vec) {
    case 1: return nll_held_fn<K, 1>(held);
    case 2: return nll_held_fn<K, 2>(held);
    case 4: return nll_held_fn<K, 4>(held);
    case 8:
      if constexpr (sizeof(typename K::Value) == 2) return nll_held_fn<K, 8>(held);
      return nullptr;
    default: return nullptr;
  }
}

// Whether (lanes, threads, vec) is a geometry the NLL kernels take for
// [n, c] rows: see mercury_nll_fwd.
bool nll_geometry_ok(int n, int c, int lanes, int threads, int vec) {
  return n >= 1 && c >= 1 && lanes >= 1 && lanes <= kWarp && (lanes & (lanes - 1)) == 0 &&
         threads >= kWarp && threads <= kNllThreads && threads % kWarp == 0 && vec >= 1 &&
         (vec & (vec - 1)) == 0;
}

template <typename T>
bool vec_aligned(const void* p, int vec) {
  return (reinterpret_cast<uintptr_t>(p) & (vec * sizeof(T) - 1)) == 0;
}

template <typename T>
int launch_nll_fwd(const void* logits, const void* labels, void* out, int n, int c, int lanes,
                   int threads, int vec, cudaStream_t st) {
  const auto fn = nll_fn<NllFwd<T>>(c, lanes, vec);
  if (fn == nullptr || !vec_aligned<T>(logits, vec))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = threads / lanes;
  fn<<<(n + rows - 1) / rows, threads, 0, st>>>(static_cast<const T*>(logits),
                                     static_cast<const int32_t*>(labels),
                                     static_cast<float*>(out), n, c, lanes);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_nll_bwd(const void* logits, const void* labels, const void* g, void* grad, int n,
                   int c, int lanes, int threads, int vec, cudaStream_t st) {
  const auto fn = nll_fn<NllBwd<T>>(c, lanes, vec);
  if (fn == nullptr || !vec_aligned<T>(logits, vec) || !vec_aligned<T>(grad, vec))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = threads / lanes;
  fn<<<(n + rows - 1) / rows, threads, 0, st>>>(
      static_cast<const T*>(logits), static_cast<const int32_t*>(labels),
      static_cast<const float*>(g), static_cast<T*>(grad), n, c, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. The geometry (lanes, threads, vec) is
// nll_geometry() of ops/mercury_kernels.py: G lanes a row, a power of two
// up to 32; threads a block, a multiple of 32 up to 256; vec values a load,
// a power of two dividing C, of at most 16 bytes and an alignment logits
// has. Any other geometry is refused.
int mercury_nll_fwd(const void* logits, const void* labels, void* out, int n, int c,
                    int lanes, int threads, int vec, int dtype, void* stream) {
  if (!nll_geometry_ok(n, c, lanes, threads, vec)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_nll_fwd<float>(logits, labels, out, n, c, lanes, threads, vec, st);
  if (dtype == 1)
    return launch_nll_fwd<__nv_bfloat16>(logits, labels, out, n, c, lanes, threads, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// grad = (softmax(logits) - onehot(labels))·g in the logits' dtype; g is
// float32. dtype and the geometry as for mercury_nll_fwd, with vec a width
// both logits and grad are aligned to: the stores are as wide as the loads.
int mercury_nll_bwd(const void* logits, const void* labels, const void* g, void* grad, int n,
                    int c, int lanes, int threads, int vec, int dtype, void* stream) {
  if (!nll_geometry_ok(n, c, lanes, threads, vec)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_nll_bwd<float>(logits, labels, g, grad, n, c, lanes, threads, vec, st);
  if (dtype == 1)
    return launch_nll_bwd<__nv_bfloat16>(logits, labels, g, grad, n, c, lanes, threads, vec,
                                         st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The largest cluster size, up to kMaxCluster, that the card can schedule
// for a selection block of `threads` threads and `smem` bytes of dynamic
// shared memory (cudaOccupancyMaxActiveClusters); 1 if no cluster fits.
// The wrappers ask once and hand it to draw_geometry().
int mercury_cluster_limit(int threads, int smem) {
  const SelectFn fn = select_fn<true>(true, true);
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
          cudaSuccess) {
    (void)cudaGetLastError();
    return 1;
  }
  for (int k = kMaxCluster; k > 1; k /= 2) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = k;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(k);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int count = 0;
    if (cudaOccupancyMaxActiveClusters(&count, fn, &cfg) == cudaSuccess && count > 0) return k;
    (void)cudaGetLastError();
  }
  return 1;
}

// The geometry (clusters, threads, per_block, run, smem bytes) is
// draw_geometry() of ops/mercury_kernels.py.
int mercury_score_and_draw(const void* losses, const void* ema, const void* uniforms,
                           float alpha, int n, int b, int clusters, int threads,
                           int per_block, int run, int smem, void* probs, void* selected,
                           void* scaled, void* stream) {
  DrawArgs a{};
  a.vals = static_cast<const float*>(losses);
  a.ema = static_cast<const float*>(ema);
  a.uniforms = static_cast<const float*>(uniforms);
  a.alpha = alpha;
  a.n = n;
  a.b = b;
  a.per_block = per_block;
  a.run = run;
  a.probs = static_cast<float*>(probs);
  a.selected = static_cast<int32_t*>(selected);
  a.scaled = static_cast<float*>(scaled);
  return launch_select<false>(a, clusters, threads, smem, static_cast<cudaStream_t>(stream));
}

int mercury_table_refresh_draw(const void* table, const void* slots, const void* rscores,
                               const void* ema, const void* uniforms, float alpha,
                               float decay, int n, int r, int b, int clusters, int threads,
                               int per_block, int run, int smem, void* new_table,
                               void* probs, void* selected, void* scaled, void* stream) {
  DrawArgs a{};
  a.vals = static_cast<const float*>(table);
  a.slots = static_cast<const int64_t*>(slots);
  a.rscores = static_cast<const float*>(rscores);
  a.ema = static_cast<const float*>(ema);
  a.uniforms = static_cast<const float*>(uniforms);
  a.alpha = alpha;
  a.decay = decay;
  a.n = n;
  a.r = r;
  a.b = b;
  a.per_block = per_block;
  a.run = run;
  a.new_table = static_cast<float*>(new_table);
  a.probs = static_cast<float*>(probs);
  a.selected = static_cast<int32_t*>(selected);
  a.scaled = static_cast<float*>(scaled);
  return launch_select<true>(a, clusters, threads, smem, static_cast<cudaStream_t>(stream));
}

// [N, H, W, C] out from N images of the [M, H, W, C] uint8 raw: images
// rows[i] (an [N] int64 array), or with rows null the first N (M = N).
// dtype of out: 0 = float32, 1 = bfloat16. The geometry (threads, band,
// copy, smem bytes) is ingest_geometry() of ops/mercury_kernels.py; one
// that leaves the table or the staged rows without room, or a copy mode
// the shape or raw's alignment does not allow, is refused.
int mercury_augment_normalize(const void* raw, const void* rows, const void* mean,
                              const void* stdev, const void* crop, const void* flip, void* out,
                              int n, int m, int h, int w, int c, int pad, int threads, int band,
                              int copy, int smem, int dtype, void* stream) {
  const int64_t row = static_cast<int64_t>(w) * c;
  const bool shape_ok = n >= 1 && m >= 1 && h >= 1 && w >= 1 && c >= 1 && pad >= 0 &&
                        band >= 1 && band <= h;
  if (!shape_ok) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t staged = std::min<int64_t>(h, band + 2LL * pad) * row;
  const int64_t need = 4LL * kLevels * c + (staged + 15) / 16 * 16 +
                       (ingest_specialized(h, w, c) ? (dtype == 0 ? 4LL : 2LL) * band * row : 0);
  const int bands = (h + band - 1) / band;
  const bool ok = threads >= kWarp && threads <= kIngestThreads && threads % kWarp == 0 &&
                  (copy == kCopyBytes || (copy == kCopyBulk && row % 16 == 0 && aligned16(raw))) &&
                  smem >= need && bands <= 65535 &&
                  static_cast<int64_t>(h) * row <= INT32_MAX && (dtype == 0 || dtype == 1);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const IngestArgs a{static_cast<const uint8_t*>(raw), static_cast<const int64_t*>(rows),
                     static_cast<const float*>(mean), static_cast<const float*>(stdev),
                     static_cast<const int32_t*>(crop), static_cast<const uint8_t*>(flip),
                     out, m, h, w, c, pad, band};
  const bool special = ingest_specialized(h, w, c);
  const IngestFn fn = dtype == 0 ? ingest_fn<float>(special, copy)
                                 : ingest_fn<__nv_bfloat16>(special, copy);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fn<<<dim3(n, bands), threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
