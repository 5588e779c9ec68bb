// Fused link-load metrics for the H100 (sm_90a): epoch-batched, single-block
// and fleet-batched.
//
// Replaces the TPU kernels
//   src/repro/kernels/linkload/linkload.py :: linkload_pallas_batched
//   (kernel body linkload_batched_kernel), entry linkload_batched below,
//   src/repro/kernels/linkload/linkload.py :: linkload_pallas
//   (kernel body linkload_metrics_kernel), entry linkload_single below, and
//   src/repro/kernels/linkload/linkload.py :: linkload_pallas_fleet
//   (kernel body linkload_fleet_kernel), entry linkload_fleet below.  The TPU's
//   single-block kernel is its batched one at B = 1 (one W, one inv_cap), and
//   its fleet kernel is the batched one with one more leading grid axis over
//   fabrics, whose (fabric, block) pairs are independent and contiguous in the
//   (F, B, ...) layout.
// For every epoch (or pair) b and interval t it computes
//   load[t, e] = sum_c demand[b, t, c] * W[b, c, e],  util = load * inv_cap[b, e]
// and returns per row: max_e util, sum_e util, #(util > thr), sum_e load.
//
// Which body each entry takes, and why.  Two bodies below:
//   * the batched body: a CTA per (epoch, 8-row T-tile), a thread per link
//     column walking W through dependent 4-byte loads;
//   * the staged body: a CTA per pair that copies all of the pair's W, its
//     demand and inv_cap into shared memory in one cp.async round trip, then
//     scores it from there.
// All three entries take the staged body wherever it fits (T <=
// kStagedMaxRows and its shared memory: T <= 60 at C = E = 132), and the
// batched body past that.  linkload_single is the staged body over one pair
// (5.4x faster than the batched body over one pair, PERF.md).  linkload_batched
// and linkload_fleet are the staged body over their B or F*B pairs: each W is
// read once, a CTA keeps its whole 70 KB in flight, two CTAs share an SM at
// (3, 132, 132), and the card's block scheduler hands each SM its next pair
// as one finishes.  The batched body over the same pairs keeps a few bytes
// in flight a thread, launches an idle second link column for 4 of 132 links
// and 5 idle rows of 8, and runs at a quarter of the HBM rate (times in
// PERF.md §6).  Persistent CTAs walking the pairs through a ring of 2-8
// stages, with 16-byte cp.async or TMA bulk copies, were no faster at either
// of the fleet's buckets.  Past the cut the batched body's many CTAs take
// long blocks, whose staged work would grow with T on one SM.
// linkload_tiles launches the batched body whatever the shape, for
// comparisons.  The staged body sums each load over c in its own order
// (quarters of C), so every pair's bits are the same in all three entries
// (a pair of the batched engine, a pair of a fleet bucket and a single block
// give the same bits on the same inputs), and not the batched body's; both
// keep the rtol 3e-4 contract.  A pair's bits never depend on the other
// pairs of the launch: stage blocks added to a batch cannot move an epoch's.
//
// What bounds it on this card: bytes.  Every epoch carries its own routing
// weights, so W (B*C*E floats) is read once and used for only T rows; at the
// controller's shapes (B=672, T=3, C=E=132) W is 46.8 MB of the 48 MB the
// kernel reads, about 14 us at 3.35 TB/s, against 70 MFLOP (1 us at the
// 67 TFLOP/s f32 rate).  At the 22-fabric fleet's 12-pod bucket (F=15, B=96,
// T=3, C=E=132) W is 100 MB of the 103 MB read, about 31 us; padded blocks of
// a fabric with fewer than B blocks are all zeros and score zeros.
//
// Single block.  At the streaming controller's shape (T=3, C=E=132) the call
// reads 72 KB (0.02 us at 3.35 TB/s) and does 0.05 M FMAs: what is left after
// the launch is the latency of its dependent steps.  Scoring a whole trace
// under one W (the baselines: T=4032) moves 2.3 MB but does 143 MFLOP, so f32
// operations bound it (2.1 us at 67 TFLOP/s); it takes the batched body, whose
// grid is 504 T-tiles, each re-reading the same 70 KB W from L2.
//
// Design of the batched body.  The TPU kernel leans on its sequential grid:
// the four output blocks stay resident across all (e, c) steps.  A CUDA grid
// gives no order, so here one CTA owns one (epoch, T-tile) and walks all of E
// itself.  The demand tile (kRows x C) is staged in shared memory; each thread
// owns the columns e = tid, tid + kThreads, ..., reads W[b, :, e] once
// (neighbouring threads read neighbouring addresses), contracts C with f32
// FMAs (no TF32: the contract is rtol 3e-4) and folds the finished column into
// per-row partials.  A fixed-order block reduction (warp butterfly, then the
// warps in order) writes each row.  Ragged T and E are masked here; the host
// pads nothing.
//
// Design of the staged body, per pair (one CTA of staged_threads(T, E)
// threads, one per item of step 2, at most kStagedThreads):
//   1. its W (C, E), the demand transposed to (C, T padded to 4) and inv_cap
//      are copied into shared memory with cp.async, every copy in flight at
//      once (16-byte copies of W where its address and row length allow,
//      4-byte ones otherwise; nothing past the tensors is read);
//   2. the (T, E) loads from shared memory: a thread owns kLoadRows rows x
//      kLoadLinks neighbouring links over one quarter of C, so per commodity it
//      reads a float2 of W and a broadcast float4 of demand for eight f32
//      FMAs, over its quarter of c in order;
//   3. a warp per row adds the quarters in order, forms util = load * inv_cap
//      and folds max, sum util, #(util > thr) and sum load over the links
//      e = lane, lane + 32, ... in order, then a warp butterfly; lane 0 writes.
// The pair count is formed in 64 bits and refused above gridDim.x's limit, as
// the batched body's grid is.
// No atomics anywhere: every entry gives the same bits on every call.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;  // intervals per CTA (T-tile)
constexpr long long kMaxGridX = 2147483647LL;  // gridDim.x limit

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kThreads)
linkload_batched_kernel(const float* __restrict__ demand,   // (B, T, C)
                        const float* __restrict__ w,        // (B, C, E)
                        const float* __restrict__ inv_cap,  // (B, E), 0 = dead link
                        float thr, float* __restrict__ mlu, float* __restrict__ alu,
                        float* __restrict__ olr, float* __restrict__ tot,  // (B, T) each
                        int T, int C, int E, int n_ttiles) {
  extern __shared__ float dem[];  // (kRows, C) demand tile
  __shared__ float red[4][kWarps][kRows];

  const long long b = blockIdx.x / n_ttiles;  // epoch, or (fabric, block) pair
  const int t0 = (int)(blockIdx.x % n_ttiles) * kRows;
  const int tid = threadIdx.x;

  const float* dem_b = demand + (size_t)b * T * C;
  for (int i = tid; i < kRows * C; i += kThreads) {
    const int r = i / C, c = i - r * C;
    dem[i] = (t0 + r < T) ? dem_b[(size_t)(t0 + r) * C + c] : 0.0f;
  }
  __syncthreads();

  float p_max[kRows], p_alu[kRows], p_cnt[kRows], p_tot[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) p_max[r] = p_alu[r] = p_cnt[r] = p_tot[r] = 0.0f;

  const float* w_b = w + (size_t)b * C * E;
  const float* ic_b = inv_cap + (size_t)b * E;
  for (int e = tid; e < E; e += kThreads) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      const float wv = __ldg(w_b + (size_t)c * E + e);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(dem[r * C + c], wv, acc[r]);
    }
    const float ic = __ldg(ic_b + e);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float util = acc[r] * ic;
      p_max[r] = fmaxf(p_max[r], util);
      p_alu[r] += util;
      p_cnt[r] += (util > thr) ? 1.0f : 0.0f;
      p_tot[r] += acc[r];
    }
  }

  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float m = warp_max(p_max[r]);
    const float a = warp_sum(p_alu[r]);
    const float n = warp_sum(p_cnt[r]);
    const float s = warp_sum(p_tot[r]);
    if (lane == 0) {
      red[0][warp][r] = m;
      red[1][warp][r] = a;
      red[2][warp][r] = n;
      red[3][warp][r] = s;
    }
  }
  __syncthreads();
  if (tid < kRows && t0 + tid < T) {
    float m = red[0][0][tid], a = red[1][0][tid], n = red[2][0][tid], s = red[3][0][tid];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) {
      m = fmaxf(m, red[0][k][tid]);
      a += red[1][k][tid];
      n += red[2][k][tid];
      s += red[3][k][tid];
    }
    const size_t o = (size_t)b * T + t0 + tid;
    mlu[o] = m;
    alu[o] = a;
    olr[o] = n;
    tot[o] = s;
  }
}

// Launch the batched body over `pairs` independent (T, C) x (C, E) problems.
// The CTA count is formed in 64 bits: a grid wider than gridDim.x allows is
// refused, never truncated.
int launch(const void* demand, const void* w, const void* inv_cap, float thr, void* mlu,
           void* alu, void* olr, void* tot, long long pairs, int T, int C, int E,
           void* stream) {
  if (pairs < 0 || T < 0 || C < 0 || E < 0) return (int)cudaErrorInvalidValue;
  if (pairs == 0 || T == 0) return 0;
  const int n_ttiles = (T + kRows - 1) / kRows;
  const long long n_ctas = pairs * n_ttiles;
  if (n_ctas > kMaxGridX) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)kRows * C * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        linkload_batched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  linkload_batched_kernel<<<dim3((unsigned)n_ctas), kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(demand), static_cast<const float*>(w),
      static_cast<const float*>(inv_cap), thr, static_cast<float*>(mlu),
      static_cast<float*>(alu), static_cast<float*>(olr), static_cast<float*>(tot), T, C, E,
      n_ttiles);
  return (int)cudaGetLastError();
}

constexpr int kStagedThreads = 384;  // most threads of a staged-body CTA
constexpr int kLoadRows = 4;   // rows per thread in the load product
constexpr int kLoadLinks = 2;  // links per thread in the load product
constexpr int kParts = 4;      // the commodities, cut in four per load
// Longest block the staged body takes.  At C = E = 132 its shared memory ends
// first, at T = 60, where it still beats the batched body over one pair
// (chip_smoke.py phase 3); the cut keeps long blocks of narrower fabrics,
// whose work grows with T on one SM, on the batched body's many CTAs.
constexpr int kStagedMaxRows = 64;
constexpr int kSmemFloats = 227 * 1024 / 4;  // shared memory a CTA can take

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Floats of shared memory the staged body needs: W (C, ESP), the demand
// (C, TP), the kParts partial loads (T, ESP) each and inv_cap (ESP), with
// ESP = E and TP = T rounded up to 4.
__host__ inline long long staged_smem_floats(int T, int C, int E) {
  const long long esp = round_up(E, 4), tp = round_up(T, kLoadRows);
  return (long long)C * esp + (long long)C * tp + kParts * (long long)T * esp + esp;
}

// Threads of a staged-body CTA: one per item of the load product (a quarter
// of C, kLoadRows rows, kLoadLinks links), in whole warps, at most
// kStagedThreads (the 8-pod bucket's 112 items take 128 threads, not 384).
__host__ inline int staged_threads(int T, int E) {
  const long long items = (long long)kParts * (round_up(T, kLoadRows) / kLoadRows) *
                          ((E + kLoadLinks - 1) / kLoadLinks);
  const long long n = (items + 31) / 32 * 32;
  return n < 32 ? 32 : n > kStagedThreads ? kStagedThreads : (int)n;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__global__ void __launch_bounds__(kStagedThreads)
linkload_staged_kernel(const float* __restrict__ demand,   // (P, T, C)
                       const float* __restrict__ w,        // (P, C, E)
                       const float* __restrict__ inv_cap,  // (P, E), 0 = dead link
                       float thr, float* __restrict__ mlu, float* __restrict__ alu,
                       float* __restrict__ olr, float* __restrict__ tot,  // (P, T) each
                       int T, int C, int E) {
  const long long pair = blockIdx.x;
  const int ESP = round_up(E, 4), TP = round_up(T, kLoadRows);
  const size_t plane = (size_t)T * ESP;  // one (T, ESP) array
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // (C, ESP): W
  float* dem = ws + (size_t)C * ESP;            // (C, TP), zero past T
  float* ld = dem + (size_t)C * TP;             // (kParts, T, ESP) partial loads
  float* ic = ld + kParts * plane;              // (ESP,) inv_cap
  const int tid = threadIdx.x, nthr = blockDim.x;
  const float* w_p = w + (size_t)pair * C * E;
  const float* dem_p = demand + (size_t)pair * T * C;
  const float* ic_p = inv_cap + (size_t)pair * E;

  // 1. stage W, the demand (transposed) and inv_cap: every copy asynchronous,
  //    so all of them are in flight at once (W's address and row length are
  //    checked here: the wrapper passes views at a storage offset)
  if ((reinterpret_cast<size_t>(w_p) & 15) == 0 && E % 4 == 0) {  // ESP == E
    for (int i = tid; i < C * E / 4; i += nthr) cp_async16(ws + 4 * i, w_p + 4 * i);
  } else if (E > 0 && E <= nthr) {  // thread (c0, j) copies rows c0, c0 + c_step, ...
    const int c_step = nthr / E, j = tid % E;
    if (tid < c_step * E)
      for (int c = tid / E; c < C; c += c_step) cp_async4(ws + (size_t)c * ESP + j, w_p + (size_t)c * E + j);
  } else {  // more links than threads
    for (int c = 0; c < C; ++c)
      for (int j = tid; j < E; j += nthr) cp_async4(ws + (size_t)c * ESP + j, w_p + (size_t)c * E + j);
  }
  for (int c = tid; c < C; c += nthr) {
    for (int k = 0; k < T; ++k) cp_async4(dem + (size_t)c * TP + k, dem_p + (size_t)k * C + c);
    for (int k = T; k < TP; ++k) dem[(size_t)c * TP + k] = 0.0f;
  }
  for (int j = tid; j < E; j += nthr) cp_async4(ic + j, ic_p + j);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2. the (T, E) loads: a thread per (quarter of c, kLoadRows rows,
  //    kLoadLinks neighbouring links); per commodity one float2 of W and a
  //    broadcast float4 of demand, f32 FMAs over its quarter of c in order
  const int n_kg = TP / kLoadRows, n_lg = (E + kLoadLinks - 1) / kLoadLinks;
  const int c_part = (C + kParts - 1) / kParts;
  const int n_items = kParts * n_kg * n_lg;
  for (int item = tid; item < n_items; item += nthr) {
    const int p = item / (n_kg * n_lg), rest = item - p * (n_kg * n_lg);
    const int kg = rest / n_lg, j = (rest - kg * n_lg) * kLoadLinks;
    float acc[kLoadRows][kLoadLinks];
#pragma unroll
    for (int u = 0; u < kLoadRows; ++u) acc[u][0] = acc[u][1] = 0.0f;
    const float* dk = dem + kg * kLoadRows;
    const int c_end = min(C, (p + 1) * c_part);
#pragma unroll 4
    for (int c = p * c_part; c < c_end; ++c) {
      const float2 wv = *reinterpret_cast<const float2*>(ws + (size_t)c * ESP + j);
      const float4 d = *reinterpret_cast<const float4*>(dk + (size_t)c * TP);
      acc[0][0] = fmaf(d.x, wv.x, acc[0][0]);
      acc[1][0] = fmaf(d.y, wv.x, acc[1][0]);
      acc[2][0] = fmaf(d.z, wv.x, acc[2][0]);
      acc[3][0] = fmaf(d.w, wv.x, acc[3][0]);
      acc[0][1] = fmaf(d.x, wv.y, acc[0][1]);
      acc[1][1] = fmaf(d.y, wv.y, acc[1][1]);
      acc[2][1] = fmaf(d.z, wv.y, acc[2][1]);
      acc[3][1] = fmaf(d.w, wv.y, acc[3][1]);
    }
    float* ld_p = ld + p * plane;
#pragma unroll
    for (int u = 0; u < kLoadRows; ++u) {
      const int k = kg * kLoadRows + u;
      if (k < T) {
        ld_p[(size_t)k * ESP + j] = acc[u][0];
        if (j + 1 < E) ld_p[(size_t)k * ESP + j + 1] = acc[u][1];
      }
    }
  }
  __syncthreads();

  // 3. a warp per row: the quarters added in order, util, and the four
  //    metrics over the lane's links in order, then a warp butterfly
  const int lane = tid & 31, warp = tid >> 5;
  for (int t = warp; t < T; t += nthr / 32) {
    const float* row = ld + (size_t)t * ESP;
    float m = 0.0f, a = 0.0f, n = 0.0f, s = 0.0f;
    for (int e = lane; e < E; e += 32) {
      float l = row[e];
#pragma unroll
      for (int pi = 1; pi < kParts; ++pi) l += row[pi * plane + e];
      const float util = l * ic[e];
      m = fmaxf(m, util);
      a += util;
      n += (util > thr) ? 1.0f : 0.0f;
      s += l;
    }
    m = warp_max(m);
    a = warp_sum(a);
    n = warp_sum(n);
    s = warp_sum(s);
    if (lane == 0) {
      const size_t o = (size_t)pair * T + t;
      mlu[o] = m;
      alu[o] = a;
      olr[o] = n;
      tot[o] = s;
    }
  }
}

// Launch the staged body over `pairs` pairs, one CTA each.  The pair count is
// formed in 64 bits: a grid wider than gridDim.x allows is refused.
int launch_staged(const void* demand, const void* w, const void* inv_cap, float thr,
                  void* mlu, void* alu, void* olr, void* tot, long long pairs, int T, int C,
                  int E, void* stream) {
  if (pairs > kMaxGridX) return (int)cudaErrorInvalidConfiguration;
  if (pairs == 0 || T == 0) return 0;
  const size_t smem = (size_t)staged_smem_floats(T, C, E) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        linkload_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  linkload_staged_kernel<<<dim3((unsigned)pairs), staged_threads(T, E), smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(demand), static_cast<const float*>(w),
      static_cast<const float*>(inv_cap), thr, static_cast<float*>(mlu),
      static_cast<float*>(alu), static_cast<float*>(olr), static_cast<float*>(tot), T, C, E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest C the demand tile fits in shared memory for (the host checks it).
int linkload_max_commodities() { return (227 * 1024 - 4 * kWarps * kRows * 4) / (kRows * 4); }

const char* linkload_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// 1 if (T, C) blocks under (C, E) weights take the staged body (one CTA a
// block, in all three entries), 0 if they take the batched body.
int linkload_single_fits(int T, int C, int E) {
  return T >= 0 && C >= 0 && E >= 0 && T <= kStagedMaxRows &&
         staged_smem_floats(T, C, E) <= kSmemFloats;
}

// B epochs: demand (B, T, C), w (B, C, E), inv_cap (B, E); outputs (B, T) each.
int linkload_batched(const void* demand, const void* w, const void* inv_cap, float thr,
                     void* mlu, void* alu, void* olr, void* tot, int B, int T, int C, int E,
                     void* stream) {
  if (B < 0 || T < 0 || C < 0 || E < 0) return (int)cudaErrorInvalidValue;
  if (!linkload_single_fits(T, C, E))
    return launch(demand, w, inv_cap, thr, mlu, alu, olr, tot, B, T, C, E, stream);
  return launch_staged(demand, w, inv_cap, thr, mlu, alu, olr, tot, B, T, C, E, stream);
}

// The batched body over B epochs whatever the shape (what linkload_batched
// launched before it took the staged body), for comparisons.
int linkload_tiles(const void* demand, const void* w, const void* inv_cap, float thr,
                   void* mlu, void* alu, void* olr, void* tot, int B, int T, int C, int E,
                   void* stream) {
  return launch(demand, w, inv_cap, thr, mlu, alu, olr, tot, B, T, C, E, stream);
}

// Bytes of shared memory and threads of a staged-body CTA at (T, C, E).
long long linkload_single_smem_bytes(int T, int C, int E) {
  return staged_smem_floats(T, C, E) * (long long)sizeof(float);
}
int linkload_staged_threads(int T, int E) { return staged_threads(T, E); }

// One (T, C) block under one (C, E) weight matrix and one (E,) inv_cap.
int linkload_single(const void* demand, const void* w, const void* inv_cap, float thr,
                    void* mlu, void* alu, void* olr, void* tot, int T, int C, int E,
                    void* stream) {
  if (T < 0 || C < 0 || E < 0) return (int)cudaErrorInvalidValue;
  if (!linkload_single_fits(T, C, E))
    return launch(demand, w, inv_cap, thr, mlu, alu, olr, tot, 1, T, C, E, stream);
  return launch_staged(demand, w, inv_cap, thr, mlu, alu, olr, tot, 1, T, C, E, stream);
}

// F fabrics x B blocks: demand (F, B, T, C), w (F, B, C, E), inv_cap (F, B, E);
// outputs (F, B, T) each.  Every (fabric, block) pair is scored on its own.
int linkload_fleet(const void* demand, const void* w, const void* inv_cap, float thr,
                   void* mlu, void* alu, void* olr, void* tot, int F, int B, int T, int C,
                   int E, void* stream) {
  if (F < 0 || B < 0 || T < 0 || C < 0 || E < 0) return (int)cudaErrorInvalidValue;
  const long long pairs = (long long)F * B;
  if (!linkload_single_fits(T, C, E))
    return launch(demand, w, inv_cap, thr, mlu, alu, olr, tot, pairs, T, C, E, stream);
  return launch_staged(demand, w, inv_cap, thr, mlu, alu, olr, tot, pairs, T, C, E, stream);
}

}  // extern "C"
