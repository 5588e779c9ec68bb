// Causal / sliding-window GQA flash attention for the H100 (sm_90a), bfloat16
// on the tensor cores and float32 on the CUDA cores.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py :: flash_attention_pallas
//   (kernel body _kernel), entries flash_attention_bf16 / flash_attention_f32,
// and adds its gradient, entries flash_attention_bwd_bf16 / _f32 (the
// reference takes it by XLA's autodiff of its plain attention; see the
// backward section below).  The forward entries write each row's log-sum-exp
// to `lse` when it is not null (training); serving passes null.
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

// ---- backward ------------------------------------------------------------------
//
// dO -> dQ, dK, dV for the forward above, from q, k, v, the forward's output
// o and its per-row statistics lse = m + log(l) (natural log, float32).  The
// weights are recomputed, P = exp(S * scale - lse), masked entries exactly 0;
// then dP = dO V^T, D = rowsum(dO * O), dS = P * (dP - D), and
//   dV = P^T dO,  dQ = scale * dS K,  dK = scale * dS^T Q,
// with dK and dV summed over the H/KV query heads of their group.  Three
// kernels: D (a warp a row), dK/dV (a CTA a (K/V row, 64-key tile), looping
// over its group's heads and the q tiles of the causal/window band that see
// the tile) and dQ (a CTA a (q row, 64-row q tile), looping over the key tiles
// of its band, the forward's bounds).  Every sum stays inside one CTA: no
// atomics, the same bits on every call.
//
// bf16: the five products are mma.sync m16n8k16 bf16 x bf16 -> f32.  The
// dK/dV kernel works on transposed scores: S^T = K Q^T and dP^T = V dO^T (a
// warp owns 16 keys), so P^T and dS^T, rounded to bf16, go from the
// accumulators straight into the A fragments of dV += P^T dO and
// dK += dS^T Q, as the forward's P does into P V (the reference's autodiff
// rounds dS to bf16 before these products, too).  The dQ kernel forms S and
// dP as the forward does and dS feeds dQ += dS K.  The 16 x hd accumulators
// of dK and dV (or of dQ) would take 2 x hd/2 registers a thread; instead the
// eight warps pair up on 16 rows and each keeps half of the columns, both
// forming the same 16-row scores (the two score products are done twice, in
// exchange for fitting hd = 256).  At hd = 256 the dK/dV kernel takes 32-row
// q tiles.  Tiles are staged once each step (no double buffering).
//
// f32: CUDA-core FMAs with no TF32, 32 x 32 tiles: a thread owns four
// scores, and one row of the accumulators at every eighth column.

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ d_o,
                       float* __restrict__ delta, long long n_rows, int hd) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const T* a = o + row * hd;
  const T* b = d_o + row * hd;
  float acc = 0.0f;
  for (int c = lane; c < hd; c += 32) acc = fmaf(to_f32(a[c]), to_f32(b[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

constexpr int kBwdBK = 64;  // keys per tile (both bf16 kernels)
constexpr int kBwdBQ = 64;  // q rows per tile of the dQ kernel

template <int HD>
__host__ __device__ constexpr int bwd_dkdv_bq() { return HD >= 256 ? 32 : 64; }

template <int HD>
constexpr size_t bwd_dkdv_smem() {
  return (size_t)(2 * kBwdBK + 2 * bwd_dkdv_bq<HD>()) * HD * 2 + 2 * 64 * sizeof(float);
}

template <int HD>
constexpr size_t bwd_dq_smem() {
  return (size_t)(2 * kBwdBK + 2 * kBwdBQ) * HD * 2;
}

// A fragment (16 x 16) from rows m0.. of a swizzled row-major tile, k-chunk 2kk
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], uint32_t base, int m0, int kk,
                                       int row_bytes, int lane) {
  ldsm_x4(a, base + swz(m0 + (lane & 15), 2 * kk + (lane >> 4), row_bytes));
}
// B fragments of two n-tiles (rows n0..n0+15 of a row-major (n, k) tile)
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], uint32_t base, int n0, int kk,
                                       int row_bytes, int lane) {
  ldsm_x4(b, base + swz(n0 + (lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1),
                        row_bytes));
}
// B fragments of two n-tiles (16-byte chunks ch, ch+1) of a row-major (k, n)
// tile, rows k0..k0+15
__device__ __forceinline__ void frag_bt(uint32_t (&b)[4], uint32_t base, int k0, int ch,
                                        int row_bytes, int lane) {
  ldsm_x4_trans(b, base + swz(k0 + (lane & 7) + (((lane >> 3) & 1) << 3), ch + (lane >> 4),
                              row_bytes));
}

__device__ __forceinline__ bool pair_visible(int qi, int kj, int Sq, int Sk, int causal,
                                             int window) {
  bool ok = kj < Sk && qi < Sq;
  if (causal) ok = ok && kj <= qi;
  if (window > 0) ok = ok && kj > qi - window;
  return ok;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ d_o,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           int Sq, int Sk, int hd, int n_heads, int n_kv, int causal,
                           int window, float scale, int n_ktiles, int vec) {
  constexpr int BQ = bwd_dkdv_bq<HD>(), BK = kBwdBK;
  constexpr int kRowBytes = HD * 2, kHalf = HD / 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sK = smem_raw;
  unsigned char* sV = sK + BK * kRowBytes;
  unsigned char* sQ = sV + BK * kRowBytes;
  unsigned char* sdO = sQ + BQ * kRowBytes;
  float* sL = reinterpret_cast<float*>(sdO + BQ * kRowBytes);  // lse * log2(e)
  float* sD = sL + 64;

  const long long kvr = blockIdx.x / n_ktiles;
  const int k0 = (int)(blockIdx.x % n_ktiles) * BK;
  const long long bidx = kvr / n_kv;
  const int kvh = (int)(kvr % n_kv), group = n_heads / n_kv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kr = 16 * (warp & 3);          // the warp's 16 keys in the tile
  const int ch0 = (warp >> 2) * (kHalf / 8);  // its first 16-byte column chunk
  const float scale_log2 = scale * kLog2e;

  load_tile<HD>(sK, k + (size_t)kvr * Sk * hd, k0, BK, Sk, hd, vec);
  load_tile<HD>(sV, v + (size_t)kvr * Sk * hd, k0, BK, Sk, hd, vec);
  cp_async_commit();
  const uint32_t sKu = smem_u32(sK), sVu = smem_u32(sV), sQu = smem_u32(sQ),
                 sdOu = smem_u32(sdO);

  float dk_acc[kHalf / 8][4], dv_acc[kHalf / 8][4];
#pragma unroll
  for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.0f;

  // q rows that see some key of [k0, k0 + BK): [q_lo, q_hi)
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + BK - 1 + window) : Sq;
  const int key_lo = k0 + kr, key_hi = key_lo + 15;  // the warp's keys

  for (int hh = 0; hh < group; ++hh) {
    const long long r = bidx * n_heads + (long long)kvh * group + hh;
    const __nv_bfloat16* q_r = q + (size_t)r * Sq * hd;
    const __nv_bfloat16* do_r = d_o + (size_t)r * Sq * hd;
    for (int q0 = (q_lo / BQ) * BQ; q0 < q_hi; q0 += BQ) {
      __syncthreads();  // every warp is done with the previous q tile
      load_tile<HD>(sQ, q_r, q0, BQ, Sq, hd, vec);
      load_tile<HD>(sdO, do_r, q0, BQ, Sq, hd, vec);
      cp_async_commit();
      for (int i = threadIdx.x; i < BQ; i += kThreads) {
        const bool in = q0 + i < Sq;
        sL[i] = in ? lse[(size_t)r * Sq + q0 + i] * kLog2e : 0.0f;
        sD[i] = in ? delta[(size_t)r * Sq + q0 + i] : 0.0f;
      }
      cp_async_wait<0>();
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ queries a warp
      float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t ak[4], av[4];
        frag_a(ak, sKu, kr, kk, kRowBytes, lane);
        frag_a(av, sVu, kr, kk, kRowBytes, lane);
#pragma unroll
        for (int np = 0; np < BQ / 16; ++np) {
          uint32_t b[4];
          frag_b(b, sQu, 16 * np, kk, kRowBytes, lane);
          mma_bf16(st[2 * np], ak, b[0], b[1]);
          mma_bf16(st[2 * np + 1], ak, b[2], b[3]);
          frag_b(b, sdOu, 16 * np, kk, kRowBytes, lane);
          mma_bf16(dpt[2 * np], av, b[0], b[1]);
          mma_bf16(dpt[2 * np + 1], av, b[2], b[3]);
        }
      }

      // P^T and dS^T in place; masks only where the warp's block straddles
      // a band edge, Sq or Sk
      const bool inside = key_hi < Sk && q0 + BQ <= Sq && (!causal || key_hi <= q0) &&
                          (window <= 0 || key_lo > q0 + BQ - 1 - window);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + 2 * t4 + (e & 1);
          const int kj = key_lo + g + (e >= 2 ? 8 : 0);
          const bool ok = inside || pair_visible(q0 + qc, kj, Sq, Sk, causal, window);
          const float p = ok ? exp2f(st[j][e] * scale_log2 - sL[qc]) : 0.0f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - sD[qc]);
        }

      // dV += P^T dO and dK += dS^T Q over the warp's half of the columns
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t ap[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                                pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                                pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                                pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
        const uint32_t as[4] = {pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
                                pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
                                pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                                pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < kHalf / 16; ++dp) {
          uint32_t b[4];
          frag_bt(b, sdOu, 16 * kk, ch0 + 2 * dp, kRowBytes, lane);
          mma_bf16(dv_acc[2 * dp], ap, b[0], b[1]);
          mma_bf16(dv_acc[2 * dp + 1], ap, b[2], b[3]);
          frag_bt(b, sQu, 16 * kk, ch0 + 2 * dp, kRowBytes, lane);
          mma_bf16(dk_acc[2 * dp], as, b[0], b[1]);
          mma_bf16(dk_acc[2 * dp + 1], as, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // with no q tile, the K/V copies are still landing
  __syncthreads();

  __nv_bfloat16* dk_r = dk + (size_t)kvr * Sk * hd;
  __nv_bfloat16* dv_r = dv + (size_t)kvr * Sk * hd;
#pragma unroll
  for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = key_lo + g + (e >= 2 ? 8 : 0);
      const int col = ch0 * 8 + 8 * j + 2 * t4 + (e & 1);
      if (row < Sk && col < hd) {
        dk_r[(size_t)row * hd + col] = __float2bfloat16_rn(dk_acc[j][e] * scale);
        dv_r[(size_t)row * hd + col] = __float2bfloat16_rn(dv_acc[j][e]);
      }
    }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ d_o,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int hd, int n_heads,
                         int n_kv, int causal, int window, float scale, int n_qtiles,
                         int vec) {
  constexpr int BQ = kBwdBQ, BK = kBwdBK;
  constexpr int kRowBytes = HD * 2, kHalf = HD / 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sQ = smem_raw;
  unsigned char* sdO = sQ + BQ * kRowBytes;
  unsigned char* sK = sdO + BQ * kRowBytes;
  unsigned char* sV = sK + BK * kRowBytes;

  const long long r = blockIdx.x / n_qtiles;
  const int q0 = (int)(blockIdx.x % n_qtiles) * BQ;
  const long long kv_row = (r / n_heads) * n_kv + (r % n_heads) / (n_heads / n_kv);
  const __nv_bfloat16* k_r = k + (size_t)kv_row * Sk * hd;
  const __nv_bfloat16* v_r = v + (size_t)kv_row * Sk * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qr = 16 * (warp & 3);             // the warp's 16 q rows in the tile
  const int ch0 = (warp >> 2) * (kHalf / 8);  // its first 16-byte column chunk
  const float scale_log2 = scale * kLog2e;

  load_tile<HD>(sQ, q + (size_t)r * Sq * hd, q0, BQ, Sq, hd, vec);
  load_tile<HD>(sdO, d_o + (size_t)r * Sq * hd, q0, BQ, Sq, hd, vec);
  cp_async_commit();
  const int qa = q0 + qr + g, qb = qa + 8;
  const float la = qa < Sq ? lse[(size_t)r * Sq + qa] * kLog2e : 0.0f;
  const float lb = qb < Sq ? lse[(size_t)r * Sq + qb] * kLog2e : 0.0f;
  const float da = qa < Sq ? delta[(size_t)r * Sq + qa] : 0.0f;
  const float db = qb < Sq ? delta[(size_t)r * Sq + qb] : 0.0f;
  const uint32_t sKu = smem_u32(sK), sVu = smem_u32(sV), sQu = smem_u32(sQ),
                 sdOu = smem_u32(sdO);

  float dq_acc[kHalf / 8][4];
#pragma unroll
  for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.0f;

  // keys that some row of this q tile may see: [k_lo, k_hi) (the forward's)
  const int k_hi = causal ? min(Sk, q0 + BQ) : Sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int w_lo = q0 + qr, w_hi = w_lo + 15;  // the warp's rows
  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // every warp is done with the previous key tile
    load_tile<HD>(sK, k_r, k0, BK, Sk, hd, vec);
    load_tile<HD>(sV, v_r, k0, BK, Sk, hd, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys a warp
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t aq[4], ao[4];
      frag_a(aq, sQu, qr, kk, kRowBytes, lane);
      frag_a(ao, sdOu, qr, kk, kRowBytes, lane);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t b[4];
        frag_b(b, sKu, 16 * np, kk, kRowBytes, lane);
        mma_bf16(s[2 * np], aq, b[0], b[1]);
        mma_bf16(s[2 * np + 1], aq, b[2], b[3]);
        frag_b(b, sVu, 16 * np, kk, kRowBytes, lane);
        mma_bf16(dp[2 * np], ao, b[0], b[1]);
        mma_bf16(dp[2 * np + 1], ao, b[2], b[3]);
      }
    }

    const bool inside = k0 + BK <= Sk && w_hi < Sq && (!causal || k0 + BK - 1 <= w_lo) &&
                        (window <= 0 || k0 > w_hi - window);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = e < 2 ? qa : qb, kj = k0 + 8 * j + 2 * t4 + (e & 1);
        const bool ok = inside || pair_visible(qi, kj, Sq, Sk, causal, window);
        const float p = ok ? exp2f(s[j][e] * scale_log2 - (e < 2 ? la : lb)) : 0.0f;
        s[j][e] = p * (dp[j][e] - (e < 2 ? da : db));  // dS
      }

    // dQ += dS K over the warp's half of the columns
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dj = 0; dj < kHalf / 16; ++dj) {
        uint32_t b[4];
        frag_bt(b, sKu, 16 * kk, ch0 + 2 * dj, kRowBytes, lane);
        mma_bf16(dq_acc[2 * dj], a, b[0], b[1]);
        mma_bf16(dq_acc[2 * dj + 1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();  // with no key tile, the q-tile copies are still landing
  __syncthreads();

  __nv_bfloat16* dq_r = dq + (size_t)r * Sq * hd;
#pragma unroll
  for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? qa : qb;
      const int col = ch0 * 8 + 8 * j + 2 * t4 + (e & 1);
      if (row < Sq && col < hd)
        dq_r[(size_t)row * hd + col] = __float2bfloat16_rn(dq_acc[j][e] * scale);
    }
}

template <int HD>
int launch_bwd_bf16(const void* q, const void* k, const void* v, const void* d_o,
                    const void* lse, const void* delta, void* dq, void* dk, void* dv,
                    long long n_kv_ctas, long long n_q_ctas, int Sq, int Sk, int hd,
                    int n_heads, int n_kv, int causal, int window, float scale, int n_ktiles,
                    int n_qtiles, int vec, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  constexpr size_t smem_kv = bwd_dkdv_smem<HD>(), smem_q = bwd_dq_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_bf16_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  if (n_kv_ctas > 0)
    flash_bwd_dkdv_bf16_kernel<HD><<<dim3((unsigned)n_kv_ctas), kThreads, smem_kv, stream>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
        static_cast<const bf*>(d_o), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf*>(dk), static_cast<bf*>(dv), Sq, Sk,
        hd, n_heads, n_kv, causal, window, scale, n_ktiles, vec);
  if (n_q_ctas > 0)
    flash_bwd_dq_bf16_kernel<HD><<<dim3((unsigned)n_q_ctas), kThreads, smem_q, stream>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
        static_cast<const bf*>(d_o), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf*>(dq), Sq, Sk, hd, n_heads, n_kv,
        causal, window, scale, n_qtiles, vec);
  return (int)cudaGetLastError();
}

// ---- float32 backward on the CUDA cores -----------------------------------------

constexpr int kFB = 32;          // rows of every f32 tile
constexpr int kFCols = kMaxHd / 8;  // accumulator columns per thread
constexpr int kLdS = kFB + 1;

__host__ __device__ constexpr size_t bwd_f32_smem(int hd) {
  return sizeof(float) * (4 * (size_t)kFB * odd_stride(hd) + 2 * (size_t)kFB * kLdS + 2 * kFB);
}

// rows [row0, row0 + kFB) of a (rows, hd) f32 matrix into a (kFB, ld) tile
__device__ __forceinline__ void load_f32_tile(float* tile, const float* g, int row0,
                                              int n_valid, int hd, int ld) {
  for (int i = threadIdx.x; i < kFB * hd; i += kThreads) {
    const int row = i / hd, c = i - row * hd;
    tile[row * ld + c] = row0 + row < n_valid ? g[(size_t)(row0 + row) * hd + c] : 0.0f;
  }
}

// this thread's four (a, b) dot products over hd: rows a = tid / 8 of A and
// b = tid % 8 + 8 m of B
__device__ __forceinline__ void dots4(float (&out)[4], const float* A, const float* B, int hd,
                                      int ld) {
  const int a = threadIdx.x >> 3, b = threadIdx.x & 7;
#pragma unroll
  for (int m = 0; m < 4; ++m) out[m] = 0.0f;
  for (int d = 0; d < hd; ++d) {
    const float x = A[a * ld + d];
#pragma unroll
    for (int m = 0; m < 4; ++m) out[m] = fmaf(x, B[(b + 8 * m) * ld + d], out[m]);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ d_o,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk,
                          int hd, int n_heads, int n_kv, int causal, int window, float scale,
                          int n_ktiles) {
  extern __shared__ float fsm[];
  const int ld = odd_stride(hd);
  float* sK = fsm;
  float* sV = sK + kFB * ld;
  float* sQ = sV + kFB * ld;
  float* sdO = sQ + kFB * ld;
  float* sP = sdO + kFB * ld;  // (key, q) weights
  float* sS = sP + kFB * kLdS;  // (key, q) dS
  float* sL = sS + kFB * kLdS;
  float* sD = sL + kFB;

  const long long kvr = blockIdx.x / n_ktiles;
  const int k0 = (int)(blockIdx.x % n_ktiles) * kFB;
  const long long bidx = kvr / n_kv;
  const int kvh = (int)(kvr % n_kv), group = n_heads / n_kv;
  const int tid = threadIdx.x, ka = tid >> 3, cb = tid & 7;

  load_f32_tile(sK, k + (size_t)kvr * Sk * hd, k0, Sk, hd, ld);
  load_f32_tile(sV, v + (size_t)kvr * Sk * hd, k0, Sk, hd, ld);
  float dk_acc[kFCols], dv_acc[kFCols];
#pragma unroll
  for (int c = 0; c < kFCols; ++c) dk_acc[c] = dv_acc[c] = 0.0f;

  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + kFB - 1 + window) : Sq;
  for (int hh = 0; hh < group; ++hh) {
    const long long r = bidx * n_heads + (long long)kvh * group + hh;
    for (int q0 = (q_lo / kFB) * kFB; q0 < q_hi; q0 += kFB) {
      __syncthreads();
      load_f32_tile(sQ, q + (size_t)r * Sq * hd, q0, Sq, hd, ld);
      load_f32_tile(sdO, d_o + (size_t)r * Sq * hd, q0, Sq, hd, ld);
      if (tid < kFB) {
        const bool in = q0 + tid < Sq;
        sL[tid] = in ? lse[(size_t)r * Sq + q0 + tid] : 0.0f;
        sD[tid] = in ? delta[(size_t)r * Sq + q0 + tid] : 0.0f;
      }
      __syncthreads();
      float s[4], dpv[4];
      dots4(s, sK, sQ, hd, ld);     // key ka against queries cb + 8m
      dots4(dpv, sV, sdO, hd, ld);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int qc = cb + 8 * m;
        const bool ok = pair_visible(q0 + qc, k0 + ka, Sq, Sk, causal, window);
        const float p = ok ? expf(s[m] * scale - sL[qc]) : 0.0f;
        sP[ka * kLdS + qc] = p;
        sS[ka * kLdS + qc] = p * (dpv[m] - sD[qc]);
      }
      __syncthreads();
      for (int i = 0; i < kFB; ++i) {
        const float p = sP[ka * kLdS + i], ds = sS[ka * kLdS + i];
#pragma unroll
        for (int c = 0; c < kFCols; ++c) {
          const int col = cb + 8 * c;
          if (col < hd) {
            dv_acc[c] = fmaf(p, sdO[i * ld + col], dv_acc[c]);
            dk_acc[c] = fmaf(ds, sQ[i * ld + col], dk_acc[c]);
          }
        }
      }
    }
  }
  if (k0 + ka < Sk) {
    float* dk_r = dk + ((size_t)kvr * Sk + k0 + ka) * hd;
    float* dv_r = dv + ((size_t)kvr * Sk + k0 + ka) * hd;
#pragma unroll
    for (int c = 0; c < kFCols; ++c) {
      const int col = cb + 8 * c;
      if (col < hd) {
        dk_r[col] = dk_acc[c] * scale;
        dv_r[col] = dv_acc[c];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ d_o,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int Sq, int Sk, int hd, int n_heads, int n_kv,
                        int causal, int window, float scale, int n_qtiles) {
  extern __shared__ float fsm[];
  const int ld = odd_stride(hd);
  float* sQ = fsm;
  float* sdO = sQ + kFB * ld;
  float* sK = sdO + kFB * ld;
  float* sV = sK + kFB * ld;
  float* sS = sV + kFB * ld;  // (q, key) dS

  const long long r = blockIdx.x / n_qtiles;
  const int q0 = (int)(blockIdx.x % n_qtiles) * kFB;
  const long long kv_row = (r / n_heads) * n_kv + (r % n_heads) / (n_heads / n_kv);
  const int tid = threadIdx.x, qa = tid >> 3, cb = tid & 7;
  load_f32_tile(sQ, q + (size_t)r * Sq * hd, q0, Sq, hd, ld);
  load_f32_tile(sdO, d_o + (size_t)r * Sq * hd, q0, Sq, hd, ld);
  const bool row_in = q0 + qa < Sq;
  const float l = row_in ? lse[(size_t)r * Sq + q0 + qa] : 0.0f;
  const float dl = row_in ? delta[(size_t)r * Sq + q0 + qa] : 0.0f;
  float dq_acc[kFCols];
#pragma unroll
  for (int c = 0; c < kFCols; ++c) dq_acc[c] = 0.0f;

  const int k_hi = causal ? min(Sk, q0 + kFB) : Sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = (k_lo / kFB) * kFB; k0 < k_hi; k0 += kFB) {
    __syncthreads();
    load_f32_tile(sK, k + (size_t)kv_row * Sk * hd, k0, Sk, hd, ld);
    load_f32_tile(sV, v + (size_t)kv_row * Sk * hd, k0, Sk, hd, ld);
    __syncthreads();
    float s[4], dpv[4];
    dots4(s, sQ, sK, hd, ld);  // query qa against keys cb + 8m
    dots4(dpv, sdO, sV, hd, ld);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int kc = cb + 8 * m;
      const bool ok = pair_visible(q0 + qa, k0 + kc, Sq, Sk, causal, window);
      const float p = ok ? expf(s[m] * scale - l) : 0.0f;
      sS[qa * kLdS + kc] = p * (dpv[m] - dl);
    }
    __syncthreads();
    for (int j = 0; j < kFB; ++j) {
      const float ds = sS[qa * kLdS + j];
#pragma unroll
      for (int c = 0; c < kFCols; ++c) {
        const int col = cb + 8 * c;
        if (col < hd) dq_acc[c] = fmaf(ds, sK[j * ld + col], dq_acc[c]);
      }
    }
  }
  if (row_in) {
    float* dq_r = dq + ((size_t)r * Sq + q0 + qa) * hd;
#pragma unroll
    for (int c = 0; c < kFCols; ++c) {
      const int col = cb + 8 * c;
      if (col < hd) dq_r[col] = dq_acc[c] * scale;
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

int flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                            const void* d_o, const void* lse, void* delta, void* dq, void* dk,
                            void* dv, int BH, int Sq, int Sk, int hd, int n_heads, int n_kv,
                            int causal, int window, float scale, void* stream) {
  if (int rc = check_args(BH, Sq, Sk, hd, n_heads, n_kv)) return rc;
  if (BH == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_rows = (long long)BH * Sq;
  const int n_ktiles = (Sk + kFB - 1) / kFB, n_qtiles = (Sq + kFB - 1) / kFB;
  const long long n_kv_ctas = (long long)BH / n_heads * n_kv * n_ktiles;
  const long long n_q_ctas = (long long)BH * n_qtiles;
  const long long n_d_ctas = (n_rows + kThreads / 32 - 1) / (kThreads / 32);
  if (n_kv_ctas > kMaxGridX || n_q_ctas > kMaxGridX || n_d_ctas > kMaxGridX)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = bwd_f32_smem(hd);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* dof = static_cast<const float*>(d_o);
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(delta);
  if (n_d_ctas > 0)
    flash_bwd_delta_kernel<float><<<dim3((unsigned)n_d_ctas), kThreads, 0, st>>>(
        static_cast<const float*>(o), dof, df, n_rows, hd);
  if (n_kv_ctas > 0)
    flash_bwd_dkdv_f32_kernel<<<dim3((unsigned)n_kv_ctas), kThreads, smem, st>>>(
        qf, kf, vf, dof, lf, df, static_cast<float*>(dk), static_cast<float*>(dv), Sq, Sk, hd,
        n_heads, n_kv, causal, window, scale, n_ktiles);
  if (n_q_ctas > 0)
    flash_bwd_dq_f32_kernel<<<dim3((unsigned)n_q_ctas), kThreads, smem, st>>>(
        qf, kf, vf, dof, lf, df, static_cast<float*>(dq), Sq, Sk, hd, n_heads, n_kv, causal,
        window, scale, n_qtiles);
  return (int)cudaGetLastError();
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                             const void* d_o, const void* lse, void* delta, void* dq, void* dk,
                             void* dv, int BH, int Sq, int Sk, int hd, int n_heads, int n_kv,
                             int causal, int window, float scale, void* stream) {
  if (int rc = check_args(BH, Sq, Sk, hd, n_heads, n_kv)) return rc;
  if (BH == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_rows = (long long)BH * Sq;
  const long long n_d_ctas = (n_rows + kThreads / 32 - 1) / (kThreads / 32);
  const int n_ktiles = (Sk + kBwdBK - 1) / kBwdBK, n_qtiles = (Sq + kBwdBQ - 1) / kBwdBQ;
  const long long n_kv_ctas = (long long)BH / n_heads * n_kv * n_ktiles;
  const long long n_q_ctas = (long long)BH * n_qtiles;
  if (n_kv_ctas > kMaxGridX || n_q_ctas > kMaxGridX || n_d_ctas > kMaxGridX)
    return (int)cudaErrorInvalidConfiguration;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(d_o);
  const int vec = hd % 8 == 0 && ptrs % 16 == 0;
  if (n_d_ctas > 0)
    flash_bwd_delta_kernel<__nv_bfloat16><<<dim3((unsigned)n_d_ctas), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(d_o),
        static_cast<float*>(delta), n_rows, hd);
  if (hd <= 64)
    return launch_bwd_bf16<64>(q, k, v, d_o, lse, delta, dq, dk, dv, n_kv_ctas, n_q_ctas, Sq,
                               Sk, hd, n_heads, n_kv, causal, window, scale, n_ktiles,
                               n_qtiles, vec, st);
  if (hd <= 128)
    return launch_bwd_bf16<128>(q, k, v, d_o, lse, delta, dq, dk, dv, n_kv_ctas, n_q_ctas, Sq,
                                Sk, hd, n_heads, n_kv, causal, window, scale, n_ktiles,
                                n_qtiles, vec, st);
  return launch_bwd_bf16<256>(q, k, v, d_o, lse, delta, dq, dk, dv, n_kv_ctas, n_q_ctas, Sq,
                              Sk, hd, n_heads, n_kv, causal, window, scale, n_ktiles, n_qtiles,
                              vec, st);
}

}  // extern "C"
