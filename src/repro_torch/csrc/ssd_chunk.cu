// Mamba2 SSD chunked scan for the H100 (sm_90a), float32.
//
// Replaces the TPU kernel
//   src/repro/kernels/ssd_chunk/ssd_chunk.py :: ssd_chunk_pallas
//   (kernel body _kernel), entry ssd_chunk below.
// x (B, H, S, P), dt (B, H, S), a (H) (negative), b/c (B, S, N) (one group)
// -> y (B, H, S, P).  Per chunk of Q steps, with L = cumsum(dt * a):
//   y_intra = ((C B^T) * exp(seg)) (dt * x),  seg[s,t] = L_s - L_t for t <= s,
//             else -1e30 before the exp (ssd.py:240, ssd_chunk.py:44-47)
//   y_inter = (C S_in) * exp(L_s)
//   S_out   = S_in * exp(L_Q) + (B * exp(L_Q - L))^T (dt * x)
// and the (N, P) state S carries from chunk to chunk, starting at zero.
//
// What bounds it on this card: operations.  A chunk does four products
// (Q x Q x N, Q x Q x P, Q x N x P, N x Q x P), 3.7 MFLOP at Q=64, N=128,
// P=64; at mamba2-130m's prefill (B=4, H=24, S=4096) that is 22.5 GFLOP
// (0.34 ms at the 67 TFLOP/s float32 rate) against 220 MB moved (0.07 ms).
//
// Design.  The TPU kernel carries the state in VMEM across a sequential grid
// (b, h, chunk).  Here one CTA owns one (b, h) and walks its chunks in order
// with the state in shared memory, so nothing carries between CTAs and no
// atomics are needed: every run gives the same bits.  Per chunk the CTA
// stages B, C and dt * x in shared memory (rows of B and C padded to an odd
// stride, so a half-warp reading 16 rows at one n hits 16 banks), one warp
// scans L, and 256 threads (16 x 16) compute 4 x 4 tiles of C B^T, then of
// y, then 8 x 4 tiles of the state update, all with float32 FMAs.  The
// masked scores are computed for 64 rows of s at a time, so a chunk of
// Q = 128 still fits the 227 KB a block can have (231,680 B at N = 128,
// P = 64); the launch opts into more than the 48 KB default.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxQ = 128;     // the L scan: one warp, four steps a lane
constexpr int kMaxN = 128;     // state update: rows ty + 16 i, i < 8
constexpr int kMaxP = 64;      // y and state columns tx + 16 j, j < 4
constexpr int kRows = 64;      // rows of s per pass over the masked scores
constexpr int kSmemMax = 232448;  // 227 KB, the most a block can opt into

__host__ __device__ constexpr int odd_stride(int n) { return n | 1; }

__host__ __device__ constexpr size_t smem_floats(int Q, int N, int P) {
  return 2 * (size_t)Q * odd_stride(N) + (size_t)Q * P + (size_t)kRows * odd_stride(Q) +
         (size_t)N * P + 2 * (size_t)Q;
}

__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const float* __restrict__ bm,
                 const float* __restrict__ cm, float* __restrict__ y, int H, int S, int P,
                 int N, int Q) {
  extern __shared__ float smem[];
  const int ldn = odd_stride(N), ldq = odd_stride(Q);
  float* sB = smem;               // (Q, ldn)
  float* sC = sB + Q * ldn;       // (Q, ldn)
  float* sX = sC + Q * ldn;       // (Q, P): dt * x
  float* sAtt = sX + Q * P;       // (kRows, ldq): (C B^T) * exp(seg), one row block
  float* sS = sAtt + kRows * ldq; // (N, P): the carried state
  float* sL = sS + N * P;         // (Q): L = cumsum(dt * a)
  float* sT = sL + Q;             // (Q): exp(L_Q - L_t)

  const int bh = blockIdx.x, bi = bh / H, hi = bh - bi * H;
  const float ah = a[hi];
  const float* x_bh = x + (size_t)bh * S * P;
  const float* dt_bh = dt + (size_t)bh * S;
  const float* b_b = bm + (size_t)bi * S * N;
  const float* c_b = cm + (size_t)bi * S * N;
  float* y_bh = y + (size_t)bh * S * P;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  for (int i = tid; i < N * P; i += kThreads) sS[i] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();  // the previous chunk's reads are done
    for (int i = tid; i < Q * N; i += kThreads) {
      const int t = i / N, n = i - t * N;
      const size_t g = (size_t)(c0 + t) * N + n;
      sB[t * ldn + n] = b_b[g];
      sC[t * ldn + n] = c_b[g];
    }
    for (int i = tid; i < Q * P; i += kThreads)
      sX[i] = x_bh[(size_t)c0 * P + i] * dt_bh[c0 + i / P];
    if (tid < 32) {  // L = cumsum(dt * a): four steps a lane, then a warp scan
      float v[4], run = 0.0f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = tid * 4 + u;
        run += (t < Q) ? dt_bh[c0 + t] * ah : 0.0f;
        v[u] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      const float excl = incl - run;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = tid * 4 + u;
        if (t < Q) sL[t] = excl + v[u];
      }
    }
    __syncthreads();
    const float lq = sL[Q - 1];
    for (int i = tid; i < Q; i += kThreads) sT[i] = expf(lq - sL[i]);

    for (int s0 = 0; s0 < Q; s0 += kRows) {
      const int t_end = min(Q, s0 + kRows);  // t <= s < s0 + kRows
      for (int t0 = 0; t0 < t_end; t0 += 64) {
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int s = s0 + ty + 16 * i;
            cv[i] = s < Q ? sC[s * ldn + n] : 0.0f;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t = t0 + tx + 16 * j;
            bv[j] = t < Q ? sB[t * ldn + n] : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int s = s0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t = t0 + tx + 16 * j;
            if (s < Q && t < t_end) {
              const float seg = (s >= t) ? sL[s] - sL[t] : -1e30f;
              sAtt[(ty + 16 * i) * ldq + t] = acc[i][j] * expf(seg);
            }
          }
        }
      }
      __syncthreads();

      float yi[4][4], ys[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yi[i][j] = ys[i][j] = 0.0f;
      for (int t = 0; t < t_end; ++t) {
        float av[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          av[i] = s0 + ty + 16 * i < Q ? sAtt[(ty + 16 * i) * ldq + t] : 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          xv[j] = p < P ? sX[t * P + p] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) yi[i][j] = fmaf(av[i], xv[j], yi[i][j]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int s = s0 + ty + 16 * i;
          cv[i] = s < Q ? sC[s * ldn + n] : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          sv[j] = p < P ? sS[n * P + p] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) ys[i][j] = fmaf(cv[i], sv[j], ys[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = s0 + ty + 16 * i;
        if (s >= Q) continue;
        const float el = expf(sL[s]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) y_bh[(size_t)(c0 + s) * P + p] = yi[i][j] + ys[i][j] * el;
        }
      }
      __syncthreads();  // sAtt is refilled, and sS updated, after this
    }

    // S_out = S_in * exp(L_Q) + (B * exp(L_Q - L))^T (dt * x); every thread
    // reads and writes only its own entries of sS
    const float dq = expf(lq);
    float up[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) up[i][j] = 0.0f;
    for (int t = 0; t < Q; ++t) {
      const float tail = sT[t];
      float bv[8], xv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int n = ty + 16 * i;
        bv[i] = n < N ? sB[t * ldn + n] * tail : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        xv[j] = p < P ? sX[t * P + p] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) up[i][j] = fmaf(bv[i], xv[j], up[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        if (n < N && p < P) sS[n * P + p] = sS[n * P + p] * dq + up[i][j];
      }
    }
  }
}

}  // namespace

extern "C" {

const char* ssd_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int ssd_chunk(const void* x, const void* dt, const void* a, const void* b, const void* c,
              void* y, int B, int H, int S, int P, int N, int Q, void* stream) {
  if (B < 0 || H < 0 || S < 0 || P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 ||
      Q > kMaxQ || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  const long long n_ctas = (long long)B * H;
  if (n_ctas == 0 || S == 0) return 0;
  if (n_ctas > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float) * smem_floats(Q, N, P);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ssd_chunk_kernel<<<dim3((unsigned)n_ctas), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<float*>(y), H, S, P, N, Q);
  return (int)cudaGetLastError();
}

}  // extern "C"
