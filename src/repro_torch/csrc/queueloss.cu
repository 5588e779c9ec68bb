// Fused link-load matmul + fluid-queue loss scan for the H100 (sm_90a):
// epoch-batched, single-block and fleet-batched.
//
// Replaces the TPU kernels
//   src/repro/kernels/queueloss/queueloss.py :: queueloss_pallas_batched
//   (kernel body queueloss_batched_kernel), entry queueloss_batched below,
//   src/repro/kernels/queueloss/queueloss.py :: queueloss_pallas
//   (kernel body queueloss_kernel), entry queueloss_single below, and
//   src/repro/kernels/queueloss/queueloss.py :: queueloss_pallas_fleet
//   (kernel body queueloss_fleet_kernel), entry queueloss_fleet below.  The
//   TPU's single-block kernel is its batched one at B = 1: one W, and one queue
//   that starts empty at the call and carries across all of its sub-steps.  Its
//   fleet kernel is the batched one with one more leading grid axis over
//   fabrics, the queue re-zeroed whenever the (fabric, block) pair changes.  In
//   the (F, B, ...) layout those pairs are contiguous and independent, so all
//   three entries launch the same body: over B epochs, over 1, and over the
//   F*B pairs, each starting from an empty queue.
// For every epoch (or pair) b, link e and sub-step k in time order:
//   load = sum_c demand[b, k, c] * W[b, c, e]
//   x = q + (load - cap[b, e]) * dt;  drop += max(0, x - buf[b, e]);  q = clip(x, 0, buf[b, e])
// with the queue empty at the start of every epoch.  Returns per sub-step the
// drops and the loads summed over links, each (B, TS).
//
// What bounds it on this card: bytes.  At the controller's shapes (B=672,
// TS=36, C=E=132) the kernel must read W (46.8 MB) and the sub-step demand
// (12.8 MB), about 18 us at 3.35 TB/s, against 0.84 GFLOP (13 us at the
// 67 TFLOP/s f32 rate).  The recurrence makes time sequential per link.
// The fleet engine's 12-pod bucket of the 22-fabric fleet (F=15, B=96, TS=36,
// C=E=132) reads 130 MB (39 us); its grid of F*B*ceil(E/128) CTAs is counted
// in 64 bits and refused above gridDim.x's limit.
// The single-block call of the streaming controller (TS=36, C=E=132) reads
// 90 KB and does 1.25 MFLOP: two CTAs of 128 link-threads, bound by the launch.
//
// Design.  The TPU kernel carries the whole queue vector in VMEM scratch
// across sequential time tiles.  Here one CTA owns one (epoch, E-tile) and one
// thread owns one link, so the queue lives in a register for the whole walk
// and nothing is carried between CTAs.  The CTA stages kSteps sub-step demand
// rows in shared memory; each thread reads its W column once per chunk
// (neighbouring threads, neighbouring addresses), forms the chunk's loads with
// f32 FMAs (no TF32) and runs the queue through them in order.  Drops and
// loads are block-reduced per sub-step in a fixed order (warp butterfly, then
// the warps in order) into partials of shape (B, TS, nE); a second small
// kernel sums the nE partials in order.  No atomics: the outputs are the same
// bits on every run.  Padded sub-steps (zero demand) only drain the queue, and
// threads past E carry no link, so neither ever drops.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // links per CTA (E-tile)
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 8;  // sub-steps per staged demand chunk
constexpr long long kMaxGridX = 2147483647LL;  // gridDim.x limit

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
queueloss_batched_kernel(const float* __restrict__ demand,  // (B, TS, C)
                         const float* __restrict__ w,       // (B, C, E)
                         const float* __restrict__ cap,     // (B, E) Gb/s
                         const float* __restrict__ buf,     // (B, E) Gb
                         float dt, float* __restrict__ drop_part,  // (B, TS, nE)
                         float* __restrict__ load_part,            // (B, TS, nE)
                         int TS, int C, int E, int n_etiles) {
  extern __shared__ float dem[];  // (kSteps, C) demand chunk
  __shared__ float red[2][kWarps][kSteps];

  const long long b = blockIdx.x / n_etiles;  // epoch, or (fabric, block) pair
  const int et = (int)(blockIdx.x % n_etiles);
  const int tid = threadIdx.x;
  const int e = et * kThreads + tid;
  const bool live = e < E;
  const int lane = tid & 31, warp = tid >> 5;

  const float* dem_b = demand + (size_t)b * TS * C;
  const float* w_e = w + (size_t)b * C * E + e;
  const float cap_e = live ? cap[(size_t)b * E + e] : 0.0f;
  const float buf_e = live ? buf[(size_t)b * E + e] : 0.0f;
  float q = 0.0f;  // the queue starts empty in every epoch

  for (int k0 = 0; k0 < TS; k0 += kSteps) {
    __syncthreads();  // the previous chunk's readers of dem/red are done
    for (int i = tid; i < kSteps * C; i += kThreads) {
      const int s = i / C, c = i - s * C;
      dem[i] = (k0 + s < TS) ? dem_b[(size_t)(k0 + s) * C + c] : 0.0f;
    }
    __syncthreads();

    float acc[kSteps];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) acc[s] = 0.0f;
    if (live) {
#pragma unroll 4
      for (int c = 0; c < C; ++c) {
        const float wv = __ldg(w_e + (size_t)c * E);
#pragma unroll
        for (int s = 0; s < kSteps; ++s) acc[s] = fmaf(dem[s * C + c], wv, acc[s]);
      }
    }
    float dr[kSteps];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      dr[s] = 0.0f;
      if (live && k0 + s < TS) {
        const float x = q + (acc[s] - cap_e) * dt;
        dr[s] = fmaxf(x - buf_e, 0.0f);
        q = fminf(fmaxf(x, 0.0f), buf_e);
      }
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const float d = warp_sum(dr[s]);
      const float l = warp_sum(acc[s]);
      if (lane == 0) {
        red[0][warp][s] = d;
        red[1][warp][s] = l;
      }
    }
    __syncthreads();
    if (tid < kSteps && k0 + tid < TS) {
      float d = red[0][0][tid], l = red[1][0][tid];
#pragma unroll
      for (int k = 1; k < kWarps; ++k) {
        d += red[0][k][tid];
        l += red[1][k][tid];
      }
      const size_t o = ((size_t)b * TS + k0 + tid) * n_etiles + et;
      drop_part[o] = d;
      load_part[o] = l;
    }
  }
}

// out[i] = sum_j part[i, j] over the n E-tiles, in order.
__global__ void sum_partials_kernel(const float* __restrict__ drop_part,
                                    const float* __restrict__ load_part,
                                    float* __restrict__ drop, float* __restrict__ load,
                                    long long rows, int n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  float d = 0.0f, l = 0.0f;
  for (int j = 0; j < n; ++j) {
    d += drop_part[i * n + j];
    l += load_part[i * n + j];
  }
  drop[i] = d;
  load[i] = l;
}

// Launch the body over `pairs` independent queue walks, then the partials pass.
// Grid sizes are formed in 64 bits: a grid wider than gridDim.x allows is
// refused, never truncated.
int launch(const void* demand, const void* w, const void* cap, const void* buf, float dt,
           void* drop, void* load, void* drop_part, void* load_part, long long pairs, int TS,
           int C, int E, void* stream) {
  if (pairs < 0 || TS < 0 || C < 0 || E < 0) return (int)cudaErrorInvalidValue;
  if (pairs == 0 || TS == 0) return 0;
  const int n_etiles = E > 0 ? (E + kThreads - 1) / kThreads : 1;
  const long long n_ctas = pairs * n_etiles;
  const long long rows = pairs * TS;
  const int threads = 256;
  const long long n_sum_ctas = (rows + threads - 1) / threads;
  if (n_ctas > kMaxGridX || n_sum_ctas > kMaxGridX) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)kSteps * C * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        queueloss_batched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  queueloss_batched_kernel<<<dim3((unsigned)n_ctas), kThreads, smem, s>>>(
      static_cast<const float*>(demand), static_cast<const float*>(w),
      static_cast<const float*>(cap), static_cast<const float*>(buf), dt,
      static_cast<float*>(drop_part), static_cast<float*>(load_part), TS, C, E, n_etiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<dim3((unsigned)n_sum_ctas), threads, 0, s>>>(
      static_cast<const float*>(drop_part), static_cast<const float*>(load_part),
      static_cast<float*>(drop), static_cast<float*>(load), rows, n_etiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int queueloss_links_per_block() { return kThreads; }

// Largest C the demand chunk fits in shared memory for (the host checks it).
int queueloss_max_commodities() {
  return (227 * 1024 - 2 * kWarps * kSteps * 4) / (kSteps * 4);
}

const char* queueloss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int queueloss_batched(const void* demand, const void* w, const void* cap, const void* buf,
                      float dt, void* drop, void* load, void* drop_part, void* load_part,
                      int B, int TS, int C, int E, void* stream) {
  return launch(demand, w, cap, buf, dt, drop, load, drop_part, load_part, B, TS, C, E, stream);
}

// One (TS, C) block under one (C, E) weight matrix; the queue starts empty.
int queueloss_single(const void* demand, const void* w, const void* cap, const void* buf,
                     float dt, void* drop, void* load, void* drop_part, void* load_part,
                     int TS, int C, int E, void* stream) {
  return launch(demand, w, cap, buf, dt, drop, load, drop_part, load_part, 1, TS, C, E, stream);
}

// F fabrics x B blocks: demand (F, B, TS, C), w (F, B, C, E), cap/buf (F, B, E);
// outputs (F, B, TS) each, partials (F, B, TS, nE).  The queue starts empty in
// every (fabric, block) pair.
int queueloss_fleet(const void* demand, const void* w, const void* cap, const void* buf,
                    float dt, void* drop, void* load, void* drop_part, void* load_part, int F,
                    int B, int TS, int C, int E, void* stream) {
  if (F < 0 || B < 0) return (int)cudaErrorInvalidValue;
  return launch(demand, w, cap, buf, dt, drop, load, drop_part, load_part, (long long)F * B,
                TS, C, E, stream);
}

}  // extern "C"
