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
//   (F, B, ...) layout.  So all three entries launch the same body: over B
//   epochs, over 1, and over the F*B (fabric, block) pairs.
// For every epoch (or pair) b and interval t it computes
//   load[t, e] = sum_c demand[b, t, c] * W[b, c, e],  util = load * inv_cap[b, e]
// and returns per row: max_e util, sum_e util, #(util > thr), sum_e load.
//
// What bounds it on this card: bytes.  Every epoch carries its own routing
// weights, so W (B*C*E floats) is read once and used for only T rows; at the
// controller's shapes (B=672, T=3, C=E=132) W is 46.8 MB of the 48 MB the
// kernel reads, about 14 us at 3.35 TB/s, against 70 MFLOP (1 us at the
// 67 TFLOP/s f32 rate).
//
// Fleet.  The fleet engine scores a whole bucket of fabrics at once: at the
// 22-fabric fleet's 12-pod bucket (F=15, B=96, T=3, C=E=132) W is 100 MB of
// the 103 MB read, about 31 us at 3.35 TB/s; the grid is F*B*ceil(T/8) CTAs,
// counted in 64 bits and refused above gridDim.x's limit.  Padded blocks of a
// fabric with fewer than B blocks are all zeros and score zeros.
//
// Single block.  At the streaming controller's shape (T=3, C=E=132) the call
// reads 72 KB (0.02 us at 3.35 TB/s): one CTA, bound by the launch.  Scoring a
// whole trace under one W (the baselines: T=4032) moves 2.3 MB but does
// 143 MFLOP, so f32 operations bound it (2.1 us at 67 TFLOP/s); the grid is
// 504 T-tiles, each re-reading the same 70 KB W from L2.
//
// Design.  The TPU kernel leans on its sequential grid: the four output
// blocks stay resident across all (e, c) steps.  A CUDA grid gives no order,
// so here one CTA owns one (epoch, T-tile) and walks all of E itself.  The
// demand tile (kRows x C) is staged in shared memory; each thread owns the
// columns e = tid, tid + kThreads, ..., reads W[b, :, e] once (neighbouring
// threads read neighbouring addresses), contracts C with f32 FMAs (no TF32:
// the contract is rtol 3e-4) and folds the finished column into per-row
// partials.  A fixed-order block reduction (warp butterfly, then the warps in
// order) writes each row, so there are no atomics and the outputs are the same
// bits on every run.  Ragged T and E are masked here; the host pads nothing.

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

// Launch the body over `pairs` independent (T, C) x (C, E) problems.  The CTA
// count is formed in 64 bits: a grid wider than gridDim.x allows is refused,
// never truncated.
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

}  // namespace

extern "C" {

// Largest C the demand tile fits in shared memory for (the host checks it).
int linkload_max_commodities() { return (227 * 1024 - 4 * kWarps * kRows * 4) / (kRows * 4); }

const char* linkload_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int linkload_batched(const void* demand, const void* w, const void* inv_cap, float thr,
                     void* mlu, void* alu, void* olr, void* tot, int B, int T, int C, int E,
                     void* stream) {
  return launch(demand, w, inv_cap, thr, mlu, alu, olr, tot, B, T, C, E, stream);
}

// One (T, C) block under one (C, E) weight matrix and one (E,) inv_cap.
int linkload_single(const void* demand, const void* w, const void* inv_cap, float thr,
                    void* mlu, void* alu, void* olr, void* tot, int T, int C, int E,
                    void* stream) {
  return launch(demand, w, inv_cap, thr, mlu, alu, olr, tot, 1, T, C, E, stream);
}

// F fabrics x B blocks: demand (F, B, T, C), w (F, B, C, E), inv_cap (F, B, E);
// outputs (F, B, T) each.  Every (fabric, block) pair is scored on its own.
int linkload_fleet(const void* demand, const void* w, const void* inv_cap, float thr,
                   void* mlu, void* alu, void* olr, void* tot, int F, int B, int T, int C,
                   int E, void* stream) {
  if (F < 0 || B < 0) return (int)cudaErrorInvalidValue;
  return launch(demand, w, inv_cap, thr, mlu, alu, olr, tot, (long long)F * B, T, C, E,
                stream);
}

}  // extern "C"
