// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t for the H100 (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/rglru_scan/rglru_scan.py :: rglru_scan_pallas
//   (kernel body _kernel), entry rglru_scan below.
// a, b, h: (B, S, D) float32, h_{-1} = 0.
//
// What bounds it on this card: bytes.  Each step is one FMA per channel on
// 12 bytes (a_t and b_t in, h_t out); at recurrentgemma-9b's prefill
// (B=2, S=4096, D=4096) the call moves 403 MB, 0.12 ms at 3.35 TB/s.
//
// Design.  The TPU kernel carries its (bb, bd) state in VMEM across a
// sequential grid of chunks.  One thread per channel walking all of S (the
// first port) leaves B*D = 8,192 threads: two warps an SM, too few loads in
// flight to feed the memory.  Here S is cut into chunks walked in parallel
// inside one CTA.  A CTA owns kChannels = 32 neighbouring channels of one
// batch row (lane = channel, so every load and store of a warp is one
// coalesced 128-byte row segment) and walks S in segments of kWarps * kSteps
// rows; in a segment, warp w owns the kSteps rows [w*kSteps, (w+1)*kSteps).
// Per segment each thread
//   1. holds its kSteps values of a and b in registers (loaded during the
//      previous segment, so the loads of one segment overlap the work of the
//      one before) and forms its chunk's aggregate: the product of a, and
//      the state reached from 0;
//   2. publishes the aggregate in shared memory; after one barrier every
//      thread walks the kWarps aggregates in order from the state entering
//      the segment, which gives the state entering its own chunk and the
//      state leaving the segment (the same bits in every thread);
//   3. re-runs its chunk from that state and writes h.
// So a and b are read once and h written once: the floor is the 403 MB
// above.  The chunks combine in a fixed order with no atomics, so the output
// is the same bits on every call; a product of a that underflows to 0 is
// used as it is (nothing divides by it).  Ragged S and D need no padding:
// rows past S read as a = 1, b = 0 (the identity) and are not written, lanes
// past D are masked.  B * ceil(D / 32) CTAs of 512 threads, two an SM: at
// B = 2, D = 4096 one wave of 256 CTAs; at B = 1, 128 CTAs of 16 warps.

#include <cuda_runtime.h>

namespace {

constexpr int kChannels = 32;  // channels per CTA: one per lane
constexpr int kWarps = 16;     // chunks per segment: one per warp
constexpr int kSteps = 8;      // rows per chunk
constexpr int kThreads = kChannels * kWarps;
constexpr int kSegment = kWarps * kSteps;  // rows per segment
constexpr long long kMaxGridX = 2147483647LL;

struct Chunk {
  float a[kSteps], b[kSteps];
};

// Rows [row0, row0 + kSteps) of one channel; a = 1, b = 0 past S or D.
__device__ __forceinline__ void load_chunk(Chunk& c, const float* __restrict__ a,
                                           const float* __restrict__ b, size_t off,
                                           int row0, int S, int D, bool live) {
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const bool in = live && row0 + u < S;
    const size_t i = off + (size_t)(row0 + u) * D;
    c.a[u] = in ? __ldg(a + i) : 1.0f;
    c.b[u] = in ? __ldg(b + i) : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, int S, int D, int n_dtiles) {
  __shared__ float agg_a[2][kWarps][kChannels];  // chunk products of a
  __shared__ float agg_h[2][kWarps][kChannels];  // chunk states from 0

  const int lane = threadIdx.x % kChannels, w = threadIdx.x / kChannels;
  const long long bi = blockIdx.x / n_dtiles;
  const int d = (int)(blockIdx.x % n_dtiles) * kChannels + lane;
  const bool live = d < D;
  const size_t off = (size_t)bi * S * D + (live ? d : 0);  // row 0 of the channel

  const int n_seg = (S + kSegment - 1) / kSegment;
  float carry = 0.0f;  // the state entering the segment
  Chunk cur, next;
  load_chunk(next, a, b, off, w * kSteps, S, D, live);
  for (int seg = 0; seg < n_seg; ++seg) {
    const int row0 = seg * kSegment + w * kSteps;
    cur = next;
    if (seg + 1 < n_seg) load_chunk(next, a, b, off, row0 + kSegment, S, D, live);

    // 1. the chunk's aggregate: prod a, and the state from 0
    float pa = cur.a[0], ph = cur.b[0];
#pragma unroll
    for (int u = 1; u < kSteps; ++u) {
      ph = cur.a[u] * ph + cur.b[u];
      pa *= cur.a[u];
    }
    const int buf = seg & 1;  // two buffers: one barrier per segment
    agg_a[buf][w][lane] = pa;
    agg_h[buf][w][lane] = ph;
    __syncthreads();

    // 2. the chunks in order: the state entering this chunk and the segment's end
    float s = carry, in = carry;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      if (k == w) in = s;
      s = agg_a[buf][k][lane] * s + agg_h[buf][k][lane];
    }
    carry = s;

    // 3. the chunk again from its entering state
    if (live) {
      float hv = in;
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        hv = cur.a[u] * hv + cur.b[u];
        if (row0 + u < S) h[off + (size_t)(row0 + u) * D] = hv;
      }
    }
  }
}

}  // namespace

extern "C" {

const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int rglru_scan(const void* a, const void* b, void* h, int B, int S, int D, void* stream) {
  if (B < 0 || S < 0 || D < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0 || S == 0) return 0;
  const int n_dtiles = (D + kChannels - 1) / kChannels;
  const long long n_ctas = (long long)B * n_dtiles;
  if (n_ctas > kMaxGridX) return (int)cudaErrorInvalidConfiguration;
  rglru_scan_kernel<<<dim3((unsigned)n_ctas), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(h), S,
      D, n_dtiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
