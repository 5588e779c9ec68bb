// Causal / sliding-window GQA flash attention for the H100 (sm_90a), float32
// and bfloat16.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py :: flash_attention_pallas
//   (kernel body _kernel), entries flash_attention_f32 / flash_attention_bf16.
// Layout as there: q (B*H, Sq, hd), k/v (B*KV, Sk, hd), out (B*H, Sq, hd) in
// q's dtype.  Row r = b*H + h of q attends over K/V row b*KV + h / (H/KV).
// Masks (flash_attention.py:45-52): kj < Sk; causal kj <= qi; with window > 0
// also kj > qi - window.  Masked scores are -2e38, the running max, sum and
// output accumulator are float32, the weights are rounded to the input dtype
// before the product with v, and the row is finished as acc / max(l, 1e-30).
//
// What bounds it on this card: operations.  At recurrentgemma-9b's prefill
// (B=2, S=4096, H=16, KV=1, hd=256, window 2048) the call moves 142 MB
// (0.04 ms at 3.35 TB/s) but does 206 GFLOP on the (q, k) pairs inside the
// band (0.21 ms at 989 TFLOP/s bf16 dense).  This first version does them
// with float32 FMAs on the CUDA cores (67 TFLOP/s peak), not the tensor
// cores: a tensor-core (wgmma) version is later work.
//
// Design.  The TPU kernel walks a sequential grid (row, q-block, k-block) and
// keeps its accumulators in VMEM across the k-blocks.  Here one CTA owns one
// (q row r, 64-row q-tile) and loops over the 64-key tiles itself, skipping
// tiles wholly outside the band (qi - window, qi]; a key tile partly inside
// is masked per pair.  The q-tile, the K and V tiles (converted to float32)
// and the score tile live in shared memory (214 KB at hd = 256, above the
// 48 KB default, so the launch opts in); each thread owns 4 x 4 scores and
// 4 rows x hd/16 columns of the output accumulator in registers.  Rows of the
// q and K tiles are padded to an odd stride, so the 16 keys a half-warp
// reads at one d fall in 16 banks.  No atomics: every run gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;       // q rows per CTA
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256; // 16 x 16: tx picks keys / columns, ty rows
constexpr int kMaxHd = 256;
constexpr int kCols = kMaxHd / 16;  // accumulator columns per thread
constexpr int kLdP = kBK + 1;
constexpr float kNegInf = -2.0e38f;
constexpr long long kMaxGridX = 2147483647LL;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

__host__ __device__ constexpr int odd_stride(int hd) { return hd | 1; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk, int hd,
                 int n_heads, int n_kv, int causal, int window, float scale,
                 int n_qtiles) {
  extern __shared__ float smem[];
  const int ldk = odd_stride(hd);
  float* sQ = smem;                  // (kBQ, ldk)
  float* sK = sQ + kBQ * ldk;        // (kBK, ldk)
  float* sV = sK + kBK * ldk;        // (kBK, hd)
  float* sP = sV + kBK * hd;         // (kBQ, kLdP) scores, then weights
  float* sM = sP + kBQ * kLdP;       // (kBQ) running max
  float* sL = sM + kBQ;              // (kBQ) running sum
  float* sA = sL + kBQ;              // (kBQ) this tile's rescale factor

  const long long r = blockIdx.x / n_qtiles;
  const int q0 = (int)(blockIdx.x % n_qtiles) * kBQ;
  const long long kv_row = (r / n_heads) * n_kv + (r % n_heads) / (n_heads / n_kv);
  const T* q_r = q + (size_t)r * Sq * hd;
  const T* k_r = k + (size_t)kv_row * Sk * hd;
  const T* v_r = v + (size_t)kv_row * Sk * hd;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int row = i / hd, c = i - row * hd;
    sQ[row * ldk + c] = (q0 + row < Sq) ? to_f(q_r[(size_t)(q0 + row) * hd + c]) : 0.0f;
  }
  if (tid < kBQ) {
    sM[tid] = kNegInf;
    sL[tid] = 0.0f;
  }

  float acc[4][kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < kCols; ++b) acc[a][b] = 0.0f;

  // keys that some row of this q-tile may see: [k_lo, k_hi)
  const int k_hi = causal ? min(Sk, q0 + kBQ) : Sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's reads of sK, sV, sP are done
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int row = i / hd, c = i - row * hd;
      const bool in = k0 + row < Sk;
      const size_t g = (size_t)(k0 + row) * hd + c;
      sK[row * ldk + c] = in ? to_f(k_r[g]) : 0.0f;
      sV[row * hd + c] = in ? to_f(v_r[g]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.0f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = sQ[(ty + 16 * a) * ldk + d];
#pragma unroll
      for (int b = 0; b < 4; ++b) kv[b] = sK[(tx + 16 * b) * ldk + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = fmaf(qv[a], kv[b], s[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qi = q0 + ty + 16 * a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int kj = k0 + tx + 16 * b;
        bool ok = kj < Sk;
        if (causal) ok = ok && kj <= qi;
        if (window > 0) ok = ok && kj > qi - window;
        sP[(ty + 16 * a) * kLdP + tx + 16 * b] = ok ? s[a][b] * scale : kNegInf;
      }
    }
    __syncthreads();

    {  // online softmax: four threads per row, in neighbouring lanes
      const int row = tid >> 2, part = tid & 3;
      float* prow = sP + row * kLdP;
      float mx = kNegInf;
      for (int j = part; j < kBK; j += 4) mx = fmaxf(mx, prow[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = sM[row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int j = part; j < kBK; j += 4) {
        const float p = expf(prow[j] - m_new);
        sum += p;
        prow[j] = to_f(from_f<T>(p));
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        sM[row] = m_new;
        sL[row] = alpha * sL[row] + sum;
        sA[row] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float alpha = sA[ty + 16 * a];
#pragma unroll
      for (int b = 0; b < kCols; ++b) acc[a][b] *= alpha;
    }
#pragma unroll 2
    for (int j = 0; j < kBK; ++j) {
      float p[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) p[a] = sP[(ty + 16 * a) * kLdP + j];
#pragma unroll
      for (int b = 0; b < kCols; ++b) {
        const int c = tx + 16 * b;
        if (c < hd) {
          const float vv = sV[j * hd + c];
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[a][b] = fmaf(p[a], vv, acc[a][b]);
        }
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = ty + 16 * a;
    if (q0 + row >= Sq) continue;
    const float l = fmaxf(sL[row], 1e-30f);
    T* o = out + ((size_t)r * Sq + q0 + row) * hd;
#pragma unroll
    for (int b = 0; b < kCols; ++b) {
      const int c = tx + 16 * b;
      if (c < hd) o[c] = from_f<T>(acc[a][b] / l);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int Sq, int Sk,
           int hd, int n_heads, int n_kv, int causal, int window, float scale,
           void* stream) {
  if (BH < 0 || Sq < 0 || Sk < 0 || hd < 1 || hd > kMaxHd || n_heads < 1 || n_kv < 1 ||
      n_heads % n_kv != 0 || BH % n_heads != 0)
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || Sq == 0) return 0;
  const int n_qtiles = (Sq + kBQ - 1) / kBQ;
  const long long n_ctas = (long long)BH * n_qtiles;
  if (n_ctas > kMaxGridX) return (int)cudaErrorInvalidConfiguration;
  const int ldk = odd_stride(hd);
  const size_t smem = sizeof(float) * ((size_t)(kBQ + kBK) * ldk + (size_t)kBK * hd +
                                       (size_t)kBQ * kLdP + 3 * kBQ);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  flash_fwd_kernel<T><<<dim3((unsigned)n_ctas), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, hd, n_heads, n_kv, causal, window, scale, n_qtiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int flash_attention_f32(const void* q, const void* k, const void* v, void* out, int BH,
                        int Sq, int Sk, int hd, int n_heads, int n_kv, int causal,
                        int window, float scale, void* stream) {
  return launch<float>(q, k, v, out, BH, Sq, Sk, hd, n_heads, n_kv, causal, window, scale,
                       stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* out, int BH,
                         int Sq, int Sk, int hd, int n_heads, int n_kv, int causal,
                         int window, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, BH, Sq, Sk, hd, n_heads, n_kv, causal, window,
                               scale, stream);
}

}  // extern "C"
