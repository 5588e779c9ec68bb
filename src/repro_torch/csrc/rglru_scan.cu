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
// sequential grid of chunks.  Here one thread owns one (b, d) channel and
// walks S in order with the state in a register, so nothing carries between
// CTAs and the result is the same bits on every run.  Neighbouring threads
// own neighbouring d, so every load and store of a step is coalesced; the
// walk loads kUnroll steps of a and b ahead of their FMAs, so each thread
// keeps 2 * kUnroll independent loads in flight to cover the memory latency.
// Ragged S and D need no padding: the last steps run one at a time and
// threads past B * D return.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // B*D = 8192 channels -> 128 CTAs on 132 SMs
constexpr int kUnroll = 16;
constexpr long long kMaxGridX = 2147483647LL;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, int S, int D, long long channels) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= channels) return;
  const long long bi = g / D;
  const size_t base = (size_t)bi * S * D + (size_t)(g - bi * D);
  const float* a_c = a + base;
  const float* b_c = b + base;
  float* h_c = h + base;
  float hv = 0.0f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = __ldg(a_c + (size_t)(t + u) * D);
      bv[u] = __ldg(b_c + (size_t)(t + u) * D);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      hv = av[u] * hv + bv[u];
      h_c[(size_t)(t + u) * D] = hv;
    }
  }
  for (; t < S; ++t) {
    hv = __ldg(a_c + (size_t)t * D) * hv + __ldg(b_c + (size_t)t * D);
    h_c[(size_t)t * D] = hv;
  }
}

}  // namespace

extern "C" {

const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int rglru_scan(const void* a, const void* b, void* h, int B, int S, int D, void* stream) {
  if (B < 0 || S < 0 || D < 0) return (int)cudaErrorInvalidValue;
  const long long channels = (long long)B * D;
  if (channels == 0 || S == 0) return 0;
  const long long n_ctas = (channels + kThreads - 1) / kThreads;
  if (n_ctas > kMaxGridX) return (int)cudaErrorInvalidConfiguration;
  rglru_scan_kernel<<<dim3((unsigned)n_ctas), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(h), S,
      D, channels);
  return (int)cudaGetLastError();
}

}  // extern "C"
