// Causal / sliding-window GQA flash attention for the H100 (sm_90a), bfloat16
// on the tensor cores and float32 on the CUDA cores.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py :: flash_attention_pallas
//   (kernel body _kernel), entries flash_attention_bf16 / flash_attention_f32.
// The entries write each row's log-sum-exp to `lse` when it is not null
// (training; the gradient is flash_attention_bwd.cu); serving passes null.
// Layout as there: q (B*H, Sq, hd), k/v (B*KV, Sk, hd), out (B*H, Sq, hd) in
// q's dtype.  Row r = b*H + h of q attends over K/V row b*KV + h / (H/KV).
// Masks (flash_attention.py:45-52): kj < Sk; causal kj <= qi; with window > 0
// also kj > qi - window.  Masked scores are -2e38, the running max, sum and
// output accumulator are float32, the weights are rounded to the input dtype
// before the product with v, and the row is finished as acc / max(l, 1e-30).
// A row whose visited key tiles so far are all masked takes p = 1 on them
// (exp(-2e38 - -2e38)); the first tile with a valid key resets it exactly,
// since its alpha = exp(-2e38 - m) is 0.
//
// What bounds it on this card: operations.  At recurrentgemma-9b's prefill
// (B=2, S=4096, H=16, KV=1, hd=256, window 2048) the call moves 142 MB
// (0.04 ms at 3.35 TB/s) but does 206 GFLOP on the (q, k) pairs inside the
// band: 0.21 ms at 989 TFLOP/s bf16, which only the tensor cores reach.
//
// bf16 design (FlashAttention-2's forward on mma.sync).  One CTA of 8 warps
// owns one (q row r, 128-row q-tile), 16 rows a warp, and loops over the
// 64-key tiles that meet the band (qi - window, qi] of some row of the tile.
// Both products are mma.sync m16n8k16 bf16 x bf16 -> f32, as the TPU
// kernel's dots (flash_attention.py:43, :59-60): S = Q K^T (16 x 64 a warp,
// f32 registers), then the weights p, rounded to bf16, go from the S
// accumulators straight into the A fragments of P V (the m16n8 accumulator
// layout of two neighbouring n-tiles is the m16k16 A layout), so P never
// touches shared memory; the sum l is taken from the unrounded f32 p.  The
// 16 x 256 output accumulator is 128 f32 registers a thread; Q's fragments
// are reloaded from shared memory at every k-step.  Shared memory holds the
// q-tile (64 KB at hd = 256) and two stages of K and V (4 x 32 KB): the next
// tile's K and V are copied with cp.async while the current one is used.
// Rows are 16-byte chunks XOR-swizzled by (row & 7), so ldmatrix (.trans
// for V) reads without bank conflicts.  Only tiles that straddle a band
// edge or Sk apply the per-pair mask.  Any hd <= 256 is taken: the kernel
// is instantiated for 64, 128 and 256 columns and zero-fills the columns
// past hd in shared memory (an hd that is not a multiple of 8, or a tensor
// that is not 16-byte aligned, is copied element by element); rows past Sq
// and keys past Sk are zero-filled and masked.  The grid is row-major, so
// the q heads that share one K/V row run together and share it in L2; in a
// row the q-tiles with the most key tiles start first.
//
// f32 design.  The float32 entry keeps the CUDA-core body: its scores and
// products are plain float32 FMAs, with no TF32 rounding, which the float32
// decode-vs-forward check and the 2e-3 contract rely on.  One CTA owns one
// (q row r, 64-row q-tile); the q-tile, the K and V tiles and the score tile
// live in shared memory (214 KB at hd = 256); each thread owns 4 x 4 scores
// and 4 rows x hd/16 columns of the accumulator.  Rows of the q and K tiles
// are padded to an odd stride, so the 16 keys a half-warp reads at one d
// fall in 16 banks.  No atomics in either body: every run gives the same
// bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHd = 256;
constexpr float kNegInf = -2.0e38f;
constexpr long long kMaxGridX = 2147483647LL;

// ---- bf16 on the tensor cores ------------------------------------------------

constexpr int kTQ = 128;  // q rows per CTA, 16 per warp
constexpr int kTK = 64;   // keys per tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` of row `row` in a swizzled tile
__device__ __forceinline__ uint32_t swz(int row, int chunk, int row_bytes) {
  return (uint32_t)(row * row_bytes + ((chunk ^ (row & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + n_rows) of a (rows, hd) bf16 matrix into a
// swizzled (n_rows, HD) tile; rows >= n_valid and columns >= hd are zero.
template <int HD>
__device__ __forceinline__ void load_tile(unsigned char* tile, const __nv_bfloat16* g,
                                          int row0, int n_rows, int n_valid, int hd,
                                          bool vec) {
  constexpr int kChunks = HD / 8;
  const uint32_t base = smem_u32(tile);
  for (int i = threadIdx.x; i < n_rows * kChunks; i += kThreads) {
    const int row = i / kChunks, ch = i % kChunks;
    const int grow = row0 + row, col = ch * 8;
    const uint32_t off = swz(row, ch, HD * 2);
    if (vec) {
      const bool ok = grow < n_valid && col < hd;
      cp_async16(base + off, ok ? g + (size_t)grow * hd + col : g, ok ? 16 : 0);
    } else {
      const unsigned short* gs = reinterpret_cast<const unsigned short*>(g);
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = col + 2 * e;
        const bool rok = grow < n_valid;
        const uint32_t lo = (rok && c < hd) ? gs[(size_t)grow * hd + c] : 0u;
        const uint32_t hi = (rok && c + 1 < hd) ? gs[(size_t)grow * hd + c + 1] : 0u;
        w[e] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(tile + off) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

template <int HD>
constexpr size_t bf16_smem_bytes() {
  return (size_t)(kTQ + 4 * kTK) * HD * 2;  // q-tile, two stages of K and V
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                  float* __restrict__ lse, int Sq, int Sk, int hd, int n_heads, int n_kv,
                  int causal, int window, float scale, int n_qtiles, int vec) {
  constexpr int kRowBytes = HD * 2, kChunks = HD / 8, kTileBytes = kTK * kRowBytes;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sQ = smem_raw;
  unsigned char* sKV = smem_raw + kTQ * kRowBytes;  // stage s: K, then V

  const long long r = blockIdx.x / n_qtiles;
  const int q0 = (n_qtiles - 1 - (int)(blockIdx.x % n_qtiles)) * kTQ;
  const long long kv_row = (r / n_heads) * n_kv + (r % n_heads) / (n_heads / n_kv);
  const __nv_bfloat16* q_r = q + (size_t)r * Sq * hd;
  const __nv_bfloat16* k_r = k + (size_t)kv_row * Sk * hd;
  const __nv_bfloat16* v_r = v + (size_t)kv_row * Sk * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // key tiles that some row of this q-tile may see: keys [k_lo, k_hi)
  const int k_hi = causal ? min(Sk, q0 + kTQ) : Sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_first = k_lo / kTK;
  const int n_tiles = max(0, (k_hi + kTK - 1) / kTK - t_first);

  load_tile<HD>(sQ, q_r, q0, kTQ, Sq, hd, vec);
  if (n_tiles > 0) {
    load_tile<HD>(sKV, k_r, t_first * kTK, kTK, Sk, hd, vec);
    load_tile<HD>(sKV + kTileBytes, v_r, t_first * kTK, kTK, Sk, hd, vec);
  }
  cp_async_commit();

  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;  // rows g, g + 8
  const int row_w = warp * 16;                             // the warp's rows
  const int qa = q0 + row_w + g, qb = qa + 8;
  const int w_lo = q0 + row_w, w_hi = w_lo + 15;
  const uint32_t sQu = smem_u32(sQ);

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = (t_first + it) * kTK;
    if (it + 1 < n_tiles) {
      unsigned char* nxt = sKV + ((it + 1) & 1) * 2 * kTileBytes;
      load_tile<HD>(nxt, k_r, k0 + kTK, kTK, Sk, hd, vec);
      load_tile<HD>(nxt + kTileBytes, v_r, k0 + kTK, kTK, Sk, hd, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and the q-tile) have landed
    __syncthreads();
    const uint32_t sK = smem_u32(sKV + (it & 1) * 2 * kTileBytes);
    const uint32_t sV = sK + kTileBytes;

    // S = Q K^T: 16 rows x 64 keys a warp, eight n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, sQu + swz(row_w + (lane & 15), 2 * kk + (lane >> 4), kRowBytes));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(b, sK + swz(16 * np + (lane & 7) + ((lane >> 4) << 3),
                            2 * kk + ((lane >> 3) & 1), kRowBytes));
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    // scale; mask only a tile that straddles a band edge or Sk for this warp
    const bool inside = k0 + kTK <= Sk && (!causal || k0 + kTK - 1 <= w_lo) &&
                        (window <= 0 || k0 > w_hi - window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (!inside) {
          const int qi = e < 2 ? qa : qb, kj = k0 + 8 * j + 2 * t4 + (e & 1);
          bool ok = kj < Sk;
          if (causal) ok = ok && kj <= qi;
          if (window > 0) ok = ok && kj > qi - window;
          if (!ok) x = kNegInf;
        }
        s[j][e] = x;
      }

    // online softmax: a row's 64 scores lie in the 4 threads of a quad
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = exp2f((m0 - mx0) * kLog2e), alpha1 = exp2f((m1 - mx1) * kLog2e);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = exp2f((s[j][0] - m0) * kLog2e);
      s[j][1] = exp2f((s[j][1] - m0) * kLog2e);
      s[j][2] = exp2f((s[j][2] - m1) * kLog2e);
      s[j][3] = exp2f((s[j][3] - m1) * kLog2e);
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
    l0 = alpha0 * l0 + ps0;  // this thread's share of the row sums
    l1 = alpha1 * l1 + ps1;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[j][0] *= alpha0;
      o[j][1] *= alpha0;
      o[j][2] *= alpha1;
      o[j][3] *= alpha1;
    }

    // O += P V: the bf16 weights of n-tiles 2kk, 2kk+1 are the A fragment
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, sV + swz(16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3),
                                  2 * dp + (lane >> 4), kRowBytes));
        mma_bf16(o[2 * dp], a, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }
  cp_async_wait<0>();
  __syncthreads();  // with no key tile, the q-tile's copies are still landing

  // finish, stage the warp's 16 rows in its own rows of the q-tile, store
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  if (lse != nullptr && t4 == 0) {  // the backward's softmax statistics
    if (qa < Sq) lse[(size_t)r * Sq + qa] = m0 + logf(l0);
    if (qb < Sq) lse[(size_t)r * Sq + qb] = m1 + logf(l1);
  }
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    *reinterpret_cast<uint32_t*>(sQ + swz(row_w + g, j, kRowBytes) + 4 * t4) =
        pack_bf16(o[j][0] / l0, o[j][1] / l0);
    *reinterpret_cast<uint32_t*>(sQ + swz(row_w + g + 8, j, kRowBytes) + 4 * t4) =
        pack_bf16(o[j][2] / l1, o[j][3] / l1);
  }
  __syncwarp();
  __nv_bfloat16* out_r = out + (size_t)r * Sq * hd;
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int row = i / kChunks, ch = i % kChunks;
    const int grow = w_lo + row, col = ch * 8;
    if (grow >= Sq || col >= hd) continue;
    const unsigned char* src = sQ + swz(row_w + row, ch, kRowBytes);
    if (vec) {
      *reinterpret_cast<uint4*>(out_r + (size_t)grow * hd + col) =
          *reinterpret_cast<const uint4*>(src);
    } else {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(src);
      for (int c = 0; c < 8 && col + c < hd; ++c) out_r[(size_t)grow * hd + col + c] = e[c];
    }
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int n_ctas,
                int Sq,
                int Sk, int hd, int n_heads, int n_kv, int causal, int window, float scale,
                int n_qtiles, int vec, cudaStream_t stream) {
  constexpr size_t smem = bf16_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_bf16_kernel<HD><<<dim3((unsigned)n_ctas), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), Sq, Sk, hd, n_heads, n_kv, causal, window, scale, n_qtiles, vec);
  return (int)cudaGetLastError();
}

// ---- float32 on the CUDA cores -----------------------------------------------

constexpr int kBQ = 64;  // q rows per CTA
constexpr int kBK = 64;  // keys per tile
constexpr int kCols = kMaxHd / 16;  // accumulator columns per thread
constexpr int kLdP = kBK + 1;

__host__ __device__ constexpr int odd_stride(int hd) { return hd | 1; }

__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk,
                 int hd, int n_heads, int n_kv, int causal, int window, float scale,
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
  const float* q_r = q + (size_t)r * Sq * hd;
  const float* k_r = k + (size_t)kv_row * Sk * hd;
  const float* v_r = v + (size_t)kv_row * Sk * hd;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int row = i / hd, c = i - row * hd;
    sQ[row * ldk + c] = (q0 + row < Sq) ? q_r[(size_t)(q0 + row) * hd + c] : 0.0f;
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
      sK[row * ldk + c] = in ? k_r[g] : 0.0f;
      sV[row * hd + c] = in ? v_r[g] : 0.0f;
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
        prow[j] = p;
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
  if (lse != nullptr && tid < kBQ && q0 + tid < Sq)  // the backward's statistics
    lse[(size_t)r * Sq + q0 + tid] = sM[tid] + logf(fmaxf(sL[tid], 1e-30f));
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = ty + 16 * a;
    if (q0 + row >= Sq) continue;
    const float l = fmaxf(sL[row], 1e-30f);
    float* o = out + ((size_t)r * Sq + q0 + row) * hd;
#pragma unroll
    for (int b = 0; b < kCols; ++b) {
      const int c = tx + 16 * b;
      if (c < hd) o[c] = acc[a][b] / l;
    }
  }
}

int check_args(int BH, int Sq, int Sk, int hd, int n_heads, int n_kv) {
  if (BH < 0 || Sq < 0 || Sk < 0 || hd < 1 || hd > kMaxHd || n_heads < 1 || n_kv < 1 ||
      n_heads % n_kv != 0 || BH % n_heads != 0)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int flash_attention_f32(const void* q, const void* k, const void* v, void* out, void* lse,
                        int BH, int Sq, int Sk, int hd, int n_heads, int n_kv, int causal,
                        int window, float scale, void* stream) {
  if (int rc = check_args(BH, Sq, Sk, hd, n_heads, n_kv)) return rc;
  if (BH == 0 || Sq == 0) return 0;
  const int n_qtiles = (Sq + kBQ - 1) / kBQ;
  const long long n_ctas = (long long)BH * n_qtiles;
  if (n_ctas > kMaxGridX) return (int)cudaErrorInvalidConfiguration;
  const int ldk = odd_stride(hd);
  const size_t smem = sizeof(float) * ((size_t)(kBQ + kBK) * ldk + (size_t)kBK * hd +
                                       (size_t)kBQ * kLdP + 3 * kBQ);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  flash_f32_kernel<<<dim3((unsigned)n_ctas), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), static_cast<float*>(lse), Sq,
      Sk, hd, n_heads, n_kv, causal, window, scale, n_qtiles);
  return (int)cudaGetLastError();
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* out, void* lse,
                         int BH, int Sq, int Sk, int hd, int n_heads, int n_kv, int causal,
                         int window, float scale, void* stream) {
  if (int rc = check_args(BH, Sq, Sk, hd, n_heads, n_kv)) return rc;
  if (BH == 0 || Sq == 0) return 0;
  const int n_qtiles = (Sq + kTQ - 1) / kTQ;
  const long long n_ctas = (long long)BH * n_qtiles;
  if (n_ctas > kMaxGridX) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte copies need rows of whole 16-byte chunks and aligned tensors
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  const int vec = hd % 8 == 0 && ptrs % 16 == 0;
  if (hd <= 64)
    return launch_bf16<64>(q, k, v, out, lse, (int)n_ctas, Sq, Sk, hd, n_heads, n_kv, causal,
                           window, scale, n_qtiles, vec, st);
  if (hd <= 128)
    return launch_bf16<128>(q, k, v, out, lse, (int)n_ctas, Sq, Sk, hd, n_heads, n_kv, causal,
                            window, scale, n_qtiles, vec, st);
  return launch_bf16<256>(q, k, v, out, lse, (int)n_ctas, Sq, Sk, hd, n_heads, n_kv, causal,
                          window, scale, n_qtiles, vec, st);
}

}  // extern "C"
