// Flash attention's backward for the H100 (sm_90a): dQ, dK and dV of the
// forward in flash_attention.cu, bfloat16 on the tensor cores (wgmma) and
// float32 on the CUDA cores.
//
// Replaces no TPU kernel: the reference takes the gradient of its plain
// attention (src/repro/models/attention.py :: _sdpa) by XLA's autodiff; this
// is the hand-written gradient of #7 (flash_attention.py ::
// flash_attention_pallas).  Entries flash_attention_bwd_bf16 / _f32.  Layout
// as the forward's: q, o, dO, dq (B*H, Sq, hd); k, v, dk, dv (B*KV, Sk, hd);
// lse (B*H, Sq) float32, the forward's m + log(l).  The weights are
// recomputed, P = exp(S * scale - lse) with masked entries exactly 0; then
// dP = dO V^T, D = rowsum(dO * O), dS = P * (dP - D), and
//   dV = P^T dO,  dQ = scale * dS K,  dK = scale * dS^T Q,
// dK and dV summed over the H/KV query heads of their group.  Two launches:
// dQ, which also computes D for its rows and writes it, then dK/dV.  Every
// sum runs in a fixed order: no atomics, the same bits on every call.
//
// What bounds it on this card: operations.  At llama3-8b's training shape
// (B=2, S=2048, H/KV=32/8, hd 128, causal) the five products take 172 GFLOP
// on the (q, k) pairs of the band: 0.17 ms at 989 TFLOP/s bf16.
//
// bf16 design.  All products are wgmma m64nNk16 bf16 x bf16 -> f32, with
// both operands in shared memory in wgmma's 128-byte-swizzle layout (below),
// or, for dQ += dS K, A from registers.  The tiles of Q, dO, K and V arrive
// by TMA in 64 x 64 boxes, whose 128-byte swizzle is that layout, behind
// mbarriers; one thread issues them, the next tile's while the current one
// is used.
//   dK/dV: a CTA owns 64 keys of one K/V row and some heads of its group;
//   the heads of a group are split over a thread-block cluster of up to 8
//   CTAs (recurrentgemma's group of 16: 8 CTAs of 2 heads), and after the
//   loop the cluster sums its CTAs' f32 dK and dV through distributed shared
//   memory in rank order (a group in one CTA stores them straight out).  Two
//   warpgroups; for every 64-row q tile of the band, warpgroup w forms
//   S^T = K Q^T and dP^T = V dO^T over queries [32w, 32w + 32) (each score
//   once), writes P^T and dS^T in bf16 (rounded as the reference's autodiff
//   rounds them) to shared memory, and then warpgroup 0 takes dV += P^T dO
//   and warpgroup 1 dK += dS^T Q over all hd columns, a 64 x hd f32
//   accumulator each (128 registers a thread at hd 256).  K and V load
//   once; Q and dO go through two stages; lse and D are read into registers
//   (one query a lane) while the scores are formed.
//   dQ: a CTA (one warpgroup) owns 64 q rows and walks the key tiles of its
//   band through two stages of K and V: S = Q K^T and dP = dO V^T, dS in
//   registers as the A operand of dQ += dS K.  So the scores are formed
//   twice in all (7 products for the 5 of one pass): a one-pass dQ would
//   need a cross-CTA sum in a fixed order (an f32 scratch and an ordered
//   semaphore per q tile); the dQ launch is timed on its own by chip_smoke.
//   The weights' exponentials are taken for every pair first, independent
//   of each other, and the mask applied by a select: a branch a pair would
//   serialize them.
// Tiles are bf16 (rows, hd) in HD/64 slabs of (rows, 64 columns), a row of a
// slab 128 bytes whose eight 16-byte chunks are XOR-permuted by (row & 7):
// the same bytes are a K-major operand (S^T = K Q^T reads Q with hd as K)
// and an MN-major one (dK += dS^T Q reads Q with the queries as K).  Any
// hd <= 256: the kernels are instantiated for 64, 128 and 256 columns and
// zero-fill past hd (TMA fills the boxes past hd or a row's end with zeros);
// an hd that is not a multiple of 8, or a tensor that is not 16-byte
// aligned, is copied element by element instead.  Rows past Sq or Sk are
// masked.
//
// f32 design.  CUDA-core FMAs with no TF32.  The same split: dK/dV a CTA per
// (K/V row, key tile, share of the group's heads) on a cluster, dQ a CTA per
// (q row, q tile) that also computes D; 256 threads, each score once per
// (q tile, key tile), a thread forms a 2 x 2 (or 1 x 2) block of scores from
// float4 reads and keeps a (keys x 4 columns) block of each accumulator;
// tiles double-buffered with cp.async.  Key tiles of 16 (and q tiles of 16
// for dQ) where 32 would give fewer than two CTAs an SM.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap (the encoder is reached through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxHd = 256;
constexpr long long kMaxGridX = 2147483647LL;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kSMs = 132;       // H100 SXM: below two CTAs an SM, f32 tiles halve

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// 2^x on the MUFU (2 ulp); flushes results below 2^-126 to 0, which the
// weights' sums cannot see
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}
// the mask, without branches: the weights are taken for every pair and the
// masked ones replaced by 0 with a select, so the compiler can interleave the
// exponentials of a thread's pairs
__device__ __forceinline__ bool pair_visible(int qi, int kj, int Sq, int Sk, int causal,
                                             int window) {
  return (kj < Sk) & (qi < Sq) & (!causal | (kj <= qi)) & ((window <= 0) | (kj > qi - window));
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// D = rowsum(dO * O) of row `row` (or 0 past n_valid): thread `part` of
// `parts` neighbouring lanes sums columns part, part + parts, ... (in chunks
// of 8 where `vec`), then the lanes add in a fixed order
template <typename T>
__device__ __forceinline__ float row_delta(const T* o, const T* d_o, int row, int n_valid,
                                           int hd, int part, int parts, bool vec) {
  float acc = 0.0f;
  if (row < n_valid) {
    const T* a = o + (size_t)row * hd;
    const T* b = d_o + (size_t)row * hd;
    constexpr int kVec = 16 / sizeof(T);
    if (vec) {
      for (int c = kVec * part; c < hd; c += kVec * parts) {
        const uint4 x = *reinterpret_cast<const uint4*>(a + c);
        const uint4 y = *reinterpret_cast<const uint4*>(b + c);
        const T* xe = reinterpret_cast<const T*>(&x);
        const T* ye = reinterpret_cast<const T*>(&y);
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc = fmaf(to_f32(xe[e]), to_f32(ye[e]), acc);
      }
    } else {
      for (int c = part; c < hd; c += parts) acc = fmaf(to_f32(a[c]), to_f32(b[c]), acc);
    }
  }
  for (int off = 1; off < parts; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// The sum over a cluster of its CTAs' f32 partials part (2 * rows, ps):
// rows [0, rows) of dV, then of dK, for keys k0.. of one K/V row.  CTA
// `rank` sums its share of the rows over CTAs 0, 1, ... in that order
// (distributed shared memory) and stores them, dK times scale.
template <typename T>
__device__ __forceinline__ void store4(T* out, float4 s, int c, int hd, bool vec);
template <>
__device__ __forceinline__ void store4<float>(float* out, float4 s, int c, int hd, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(out + c) = s;
    return;
  }
  const float e[4] = {s.x, s.y, s.z, s.w};
  for (int i = 0; i < 4 && c + i < hd; ++i) out[c + i] = e[i];
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* out, float4 s, int c,
                                                      int hd, bool vec) {
  if (vec) {
    *reinterpret_cast<uint2*>(out + c) = make_uint2(pack_bf16(s.x, s.y), pack_bf16(s.z, s.w));
    return;
  }
  const float e[4] = {s.x, s.y, s.z, s.w};
  for (int i = 0; i < 4 && c + i < hd; ++i) out[c + i] = __float2bfloat16_rn(e[i]);
}

template <typename T, int HD>
__device__ __forceinline__ void cluster_sum_store(cg::cluster_group& cluster, float* part,
                                                  int rows, int ps, T* dv_r, T* dk_r,
                                                  int k0, int Sk, int hd, float scale,
                                                  bool vec) {
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int r_lo = rank * 2 * rows / C, r_hi = (rank + 1) * 2 * rows / C;
  for (int i = threadIdx.x; i < (r_hi - r_lo) * (HD / 4); i += blockDim.x) {
    const int row = r_lo + i / (HD / 4), c = (i % (HD / 4)) * 4;
    const int mat = row >= rows, key = k0 + row - mat * rows;
    if (c >= hd || key >= Sk) continue;
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int j = 0; j < C; ++j) {
      const float4 x =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, j) + row * ps + c);
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    if (mat) {
      s.x *= scale;
      s.y *= scale;
      s.z *= scale;
      s.w *= scale;
    }
    store4<T>((mat ? dk_r : dv_r) + (size_t)key * hd, s, c, hd, vec);
  }
}

// ---- bf16 on the tensor cores (wgmma) ---------------------------------------

// byte offset of 16-byte chunk ch (columns 8ch..8ch+7) of row r in a swizzled
// (rows, HD) tile: slab ch / 8, then the row's 128 bytes, chunks XOR (r & 7)
__device__ __forceinline__ uint32_t sw_off(int r, int ch, int rows) {
  return (uint32_t)((ch >> 3) * rows * 128 + r * 128 + (((ch & 7) ^ (r & 7)) << 4));
}

// rows [row0, row0 + ROWS) of a (rows, hd) bf16 matrix into a swizzled
// (ROWS, HD) tile, element by element; rows >= n_valid and columns >= hd are
// zero.  The fallback of the TMA copies, for rows that are not whole 16-byte
// chunks (an hd that is not a multiple of 8) or tensors not 16-byte aligned.
template <int HD, int ROWS, int NT>
__device__ __forceinline__ void load_sw(unsigned char* tile, const __nv_bfloat16* g, int row0,
                                        int n_valid, int hd) {
  constexpr int kChunks = HD / 8;
  const unsigned short* gs = reinterpret_cast<const unsigned short*>(g);
  for (int i = threadIdx.x; i < ROWS * kChunks; i += NT) {
    const int row = i / kChunks, ch = i % kChunks;
    const int grow = row0 + row, col = ch * 8;
    const bool rok = grow < n_valid;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = col + 2 * e;
      const uint32_t lo = (rok && c < hd) ? gs[(size_t)grow * hd + c] : 0u;
      const uint32_t hi = (rok && c + 1 < hd) ? gs[(size_t)grow * hd + c + 1] : 0u;
      w[e] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(tile + sw_off(row, ch, ROWS)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// wgmma shared-memory descriptor of a 128-byte-swizzle operand at byte
// address addr: lbo the byte stride between 64-column slabs (an MN-major
// operand wider than 64; 16 for a K-major one, where it is unused), 1024
// bytes between groups of 8 rows
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared-memory writes of the generic proxy (st.shared, cp.async) made
// visible to wgmma's reads (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from touching accumulators across an asynchronous wgmma
template <int M>
__device__ __forceinline__ void fence_regs(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int M>
__device__ __forceinline__ void zero(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) d[i] = 0.0f;
}

// ---- TMA and mbarriers ------------------------------------------------------
// A tile of 16-byte rows arrives by TMA (cp.async.bulk.tensor) in 64 x 64
// boxes whose 128-byte swizzle is the slab layout above; the copy reports its
// bytes to an mbarrier, which the consumers wait on by phase parity.

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// box (64 columns from c0, 64 rows from row0) of matrix mat of a 3-D
// (mats, rows, hd) bf16 tensor map into shared memory at dst
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, int c0, int row0,
                                        int mat, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(row0), "r"(mat), "r"(bar)
      : "memory");
}
// rows [row0, row0 + 64) of matrix mat into a swizzled (64, HD) tile
template <int HD>
__device__ __forceinline__ void tma_tile(uint32_t tile, const CUtensorMap* map, int row0,
                                         int mat, uint32_t bar) {
#pragma unroll
  for (int s = 0; s < HD / 64; ++s) tma_box(tile + s * 64 * 128, map, 64 * s, row0, mat, bar);
}

// d[i..i+7] as eight read-write f32 operands of an asm statement
#define FA_D8(i)                                                                         \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), \
      "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define FA_D16(i) FA_D8(i), FA_D8((i) + 8)
#define FA_D64(i) FA_D16(i), FA_D16((i) + 16), FA_D16((i) + 32), FA_D16((i) + 48)

template <int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      : FA_D16(0)
      : "l"(da), "l"(db), "r"(acc), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : FA_D16(0), FA_D16(16)
      : "l"(da), "l"(db), "r"(acc), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : FA_D64(0)
      : "l"(da), "l"(db), "r"(acc), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da, uint64_t db,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : FA_D64(0), FA_D64(64)
      : "l"(da), "l"(db), "r"(acc), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : FA_D16(0), FA_D16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : FA_D64(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : FA_D64(0), FA_D64(64)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

// d (+)= A B over all N = HD columns, A and B from shared memory (SS) or A
// from registers (RS); TB = 1: B is MN-major
template <int N, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 32) wgmma_ss_n32<TB>(d, da, db, acc);
  else if constexpr (N == 64) wgmma_ss_n64<TB>(d, da, db, acc);
  else if constexpr (N == 128) wgmma_ss_n128<TB>(d, da, db, acc);
  else wgmma_ss_n256<TB>(d, da, db, acc);
}
template <int N, int TB>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                       int acc) {
  if constexpr (N == 64) wgmma_rs_n64<TB>(d, a, db, acc);
  else if constexpr (N == 128) wgmma_rs_n128<TB>(d, a, db, acc);
  else wgmma_rs_n256<TB>(d, a, db, acc);
}

constexpr int kTileRows = 64;  // keys per dK/dV CTA, q rows per tile (both kernels)
constexpr int kSlab = kTileRows * 128;  // bytes of one 64-column slab of a tile

template <int HD>
__host__ __device__ constexpr int tile_bytes() { return kTileRows * HD * 2; }

// dK/dV shared memory: K, V, two stages of (Q, dO), P^T and dS^T (64 x 64
// bf16 each), three mbarriers (K/V, stages); after the loop the f32 partial
// sums (2, 64, HD + 8) reuse the stages, P^T and dS^T.  At hd 128 this is
// 112 KB: two CTAs an SM.
template <int HD>
constexpr size_t dkdv_smem() {
  return (size_t)6 * tile_bytes<HD>() + 2 * 8192 + 3 * 8;
}

template <int HD>
__global__ void __launch_bounds__(256, HD == 64 ? 3 : HD <= 128 ? 2 : 1)
flash_bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ d_o,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           int Sq, int Sk, int hd, int n_heads, int n_kv, int causal,
                           int window, float scale, long long n_kv_rows, int vec) {
  constexpr int T = tile_bytes<HD>(), BQ = kTileRows, PS = HD + 8;
  static_assert(2 * kTileRows * PS * sizeof(float) <= 4 * T + 2 * 8192, "partials fit");
  extern __shared__ __align__(1024) unsigned char smem[];
  if (smem_u32(smem) & 1023) __trap();  // the swizzle needs 1024-byte aligned tiles
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const long long tile = blockIdx.x / C;
  const int k0 = (int)(tile / n_kv_rows) * kTileRows;  // heaviest (causal) key tiles first
  const long long kvr = tile % n_kv_rows;
  const long long bidx = kvr / n_kv;
  const int kvh = (int)(kvr % n_kv), group = n_heads / n_kv;
  const int h_lo = rank * group / C, h_hi = (rank + 1) * group / C;  // this CTA's heads
  const int tid = threadIdx.x, wg = tid >> 7;
  const int wi = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const float scale_log2 = scale * kLog2e;
  const uint32_t base = smem_u32(smem);
  unsigned char* sP = smem + 6 * T;            // P^T, then dS^T: (64 keys, 64 queries)
  const uint32_t bar = smem_u32(sP + 2 * 8192);  // K/V, then stages 0, 1
  if (vec && tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i);
    mbar_init_fence();
  }
  __syncthreads();

  // q tiles of the rows that see some key of [k0, k0 + 64)
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + kTileRows - 1 + window) : Sq;
  const int qt0 = q_lo / BQ, n_qt = max(0, (q_hi + BQ - 1) / BQ - qt0);
  const int n_it = (h_hi - h_lo) * n_qt;

  // K and V once: by TMA, or element by element where a row is not whole
  // 16-byte chunks
  if (!vec) {
    load_sw<HD, kTileRows, 256>(smem, k + (size_t)kvr * Sk * hd, k0, Sk, hd);
    load_sw<HD, kTileRows, 256>(smem + T, v + (size_t)kvr * Sk * hd, k0, Sk, hd);
  } else if (tid == 0) {
    mbar_expect_tx(bar, 2 * T);
    tma_tile<HD>(base, &tm_k, k0, (int)kvr, bar);
    tma_tile<HD>(base + T, &tm_v, k0, (int)kvr, bar);
  }
  auto row_of = [&](int it) {  // the q row of iteration it: head h_lo + it / n_qt
    return bidx * n_heads + (long long)kvh * group + h_lo + it / n_qt;
  };
  // Q and dO of iteration it into stage it & 1
  auto issue = [&](int it) {
    const long long r = row_of(it);
    const int q0 = (qt0 + it % n_qt) * BQ, s = it & 1;
    if (!vec) {
      unsigned char* st = smem + (2 + 2 * s) * T;
      load_sw<HD, kTileRows, 256>(st, q + (size_t)r * Sq * hd, q0, Sq, hd);
      load_sw<HD, kTileRows, 256>(st + T, d_o + (size_t)r * Sq * hd, q0, Sq, hd);
    } else if (tid == 0) {
      const uint32_t b = bar + 8 * (1 + s);
      mbar_expect_tx(b, 2 * T);
      tma_tile<HD>(base + (2 + 2 * s) * T, &tm_q, q0, (int)r, b);
      tma_tile<HD>(base + (3 + 2 * s) * T, &tm_do, q0, (int)r, b);
    }
  };
  if (n_it > 0) issue(0);
  fence_proxy_async();
  __syncthreads();  // element-wise copies of K, V and the first stage are in

  // Two barriers an iteration: after P^T and dS^T are written, and after
  // their products, which frees the stage, P^T and dS^T
  float acc[HD / 2];  // dV (warpgroup 0) or dK (warpgroup 1): 64 keys x HD
  zero(acc);
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) issue(it + 1);  // the other stage, free since the last barrier
    const int q0 = (qt0 + it % n_qt) * BQ;
    // lse and D of one query a lane, 32 wg + 8 (g >> 1) + 2 t4 + (g & 1),
    // read while the scores are formed; each pair's come by a shuffle
    const int qn = q0 + 32 * wg + 8 * (g >> 1) + 2 * t4 + (g & 1);
    const size_t rn = (size_t)row_of(it) * Sq + qn;
    const float lse_n = qn < Sq ? lse[rn] * kLog2e : 0.0f, d_n = qn < Sq ? delta[rn] : 0.0f;
    if (vec) {
      mbar_wait(bar, 0);
      mbar_wait(bar + 8 * (1 + (it & 1)), (it >> 1) & 1);
    }
    const uint32_t sQ = base + (2 + 2 * (it & 1)) * T, sdO = sQ + T;

    // S^T = K Q^T and dP^T = V dO^T, 64 keys x this warpgroup's 32 queries
    // (the first k-step overwrites: the accumulators need no zeroing, so the
    // two chains issue back to back)
    float st[16], dpt[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kSlab + (kk & 3) * 32;
      wgmma_ss_n32<0>(st, sw128_desc(base + off, 16),
                      sw128_desc(sQ + off + wg * 32 * 128, 16), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kSlab + (kk & 3) * 32;
      wgmma_ss_n32<0>(dpt, sw128_desc(base + T + off, 16),
                      sw128_desc(sdO + off + wg * 32 * 128, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(st);
    fence_regs(dpt);

    // P^T and dS^T, rounded to bf16, into shared memory; the mask only where
    // the warp's 16 keys x the warpgroup's 32 queries straddle an edge
    const int key_lo = k0 + 16 * wi, qw = q0 + 32 * wg;
    const bool inside = key_lo + 15 < Sk && qw + 31 < Sq && (!causal || key_lo + 15 <= qw) &&
                        (window <= 0 || key_lo > qw + 31 - window);
    // the exponentials of all 16 pairs first, independent of each other;
    // pair i's query 8 (i >> 2) + 2 t4 + (i & 1) is lane 4 (2 (i >> 2) + (i & 1)) + t4's
    float dl[16];  // D of each pair's query
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int src = 4 * (2 * (i >> 2) + (i & 1)) + t4;
      st[i] = exp2_ftz(st[i] * scale_log2 - __shfl_sync(0xffffffffu, lse_n, src));
      dl[i] = __shfl_sync(0xffffffffu, d_n, src);
    }
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const int j = i >> 2, row = 16 * wi + g + 8 * ((i >> 1) & 1), kj = k0 + row;
      const int qi = q0 + 32 * wg + 8 * j + 2 * t4;
      const float p0 = inside | pair_visible(qi, kj, Sq, Sk, causal, window) ? st[i] : 0.0f;
      const float p1 =
          inside | pair_visible(qi + 1, kj, Sq, Sk, causal, window) ? st[i + 1] : 0.0f;
      const uint32_t off = row * 128 + (((4 * wg + j) ^ (row & 7)) << 4) + 4 * t4;
      *reinterpret_cast<uint32_t*>(sP + off) = pack_bf16(p0, p1);
      *reinterpret_cast<uint32_t*>(sP + 8192 + off) =
          pack_bf16(p0 * (dpt[i] - dl[i]), p1 * (dpt[i + 1] - dl[i + 1]));
    }
    fence_proxy_async();
    __syncthreads();  // both warpgroups' queries of P^T and dS^T are written

    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1): A (64 keys,
    // 64 queries) K-major, B the stage's (64 queries, HD) tile MN-major
    const uint32_t a_base = base + 6 * T + wg * 8192, b_base = wg ? sQ : sdO;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      mma_ss<HD, 1>(acc, sw128_desc(a_base + kk * 32, 16),
                    sw128_desc(b_base + kk * 16 * 128, kSlab), 1);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    fence_proxy_async();
    __syncthreads();  // the stage, P^T and dS^T are free; element-wise copies are in
  }
  if (vec) mbar_wait(bar, 0);  // with no q tile, K and V are still landing
  __syncthreads();

  if (C == 1) {  // the whole group in this CTA: dV (warpgroup 0) or dK straight out
    __nv_bfloat16* out = (wg ? dk : dv) + (size_t)kvr * Sk * hd;
    const float f = wg ? scale : 1.0f;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = k0 + 16 * wi + g + 8 * h, col = 8 * j + 2 * t4;
        if (key >= Sk || col >= hd) continue;
        const float x = acc[4 * j + 2 * h] * f, y = acc[4 * j + 2 * h + 1] * f;
        __nv_bfloat16* o = out + (size_t)key * hd + col;
        if (vec) {
          *reinterpret_cast<uint32_t*>(o) = pack_bf16(x, y);
        } else {
          o[0] = __float2bfloat16_rn(x);
          if (col + 1 < hd) o[1] = __float2bfloat16_rn(y);
        }
      }
    return;
  }
  // this CTA's f32 partials over its heads, then the cluster's sum
  float* part = reinterpret_cast<float*>(smem + 2 * T);
  float* mine = part + wg * kTileRows * PS;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(mine + (16 * wi + g + 8 * h) * PS + 8 * j + 2 * t4) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  cluster.sync();
  cluster_sum_store<__nv_bfloat16, HD>(cluster, part, kTileRows, PS, dv + (size_t)kvr * Sk * hd,
                                       dk + (size_t)kvr * Sk * hd, k0, Sk, hd, scale, vec);
  cluster.sync();  // no CTA leaves while another still reads its partials
}

// dQ shared memory: Q, dO, two stages of (K, V), three mbarriers (Q/dO,
// stages), D of the tile's rows
template <int HD>
constexpr size_t dq_smem() {
  return (size_t)6 * tile_bytes<HD>() + 32 + kTileRows * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(128, HD <= 128 ? 2 : 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ d_o,
                         const __nv_bfloat16* __restrict__ o, const float* __restrict__ lse,
                         float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Sq,
                         int Sk, int hd, int n_heads,
                         int n_kv, int causal, int window, float scale, int n_qtiles,
                         int vec) {
  constexpr int T = tile_bytes<HD>(), BK = kTileRows;
  extern __shared__ __align__(1024) unsigned char smem[];
  if (smem_u32(smem) & 1023) __trap();
  const long long r = blockIdx.x / n_qtiles;
  const int q0 = (n_qtiles - 1 - (int)(blockIdx.x % n_qtiles)) * kTileRows;
  const long long kv_row = (r / n_heads) * n_kv + (r % n_heads) / (n_heads / n_kv);
  const __nv_bfloat16* k_r = k + (size_t)kv_row * Sk * hd;
  const __nv_bfloat16* v_r = v + (size_t)kv_row * Sk * hd;
  const int tid = threadIdx.x, wi = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const float scale_log2 = scale * kLog2e;
  const uint32_t base = smem_u32(smem), bar = base + 6 * T;  // Q/dO, then stages 0, 1
  if (vec && tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i);
    mbar_init_fence();
  }
  __syncthreads();

  // Q and dO once: by TMA, or element by element where a row is not whole
  // 16-byte chunks
  if (!vec) {
    load_sw<HD, kTileRows, 128>(smem, q + (size_t)r * Sq * hd, q0, Sq, hd);
    load_sw<HD, kTileRows, 128>(smem + T, d_o + (size_t)r * Sq * hd, q0, Sq, hd);
  } else if (tid == 0) {
    mbar_expect_tx(bar, 2 * T);
    tma_tile<HD>(base, &tm_q, q0, (int)r, bar);
    tma_tile<HD>(base + T, &tm_do, q0, (int)r, bar);
  }
  // D = rowsum(dO * O) of the tile's rows, two threads a row: for this
  // CTA's rows, and into delta for the dK/dV launch that follows
  float* sD = reinterpret_cast<float*>(smem + 6 * T + 32);
  {
    const int row = tid >> 1;
    const float d = row_delta(o + (size_t)r * Sq * hd, d_o + (size_t)r * Sq * hd, q0 + row, Sq,
                              hd, tid & 1, 2, vec);
    if ((tid & 1) == 0) {
      sD[row] = d;
      if (q0 + row < Sq) delta[(size_t)r * Sq + q0 + row] = d;
    }
  }
  const int qa = q0 + 16 * wi + g, qb = qa + 8;
  const float la = qa < Sq ? lse[(size_t)r * Sq + qa] * kLog2e : 0.0f;
  const float lb = qb < Sq ? lse[(size_t)r * Sq + qb] * kLog2e : 0.0f;

  // key tiles that some row of this q tile may see: [k_lo, k_hi) (the forward's)
  const int k_hi = causal ? min(Sk, q0 + kTileRows) : Sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt0 = k_lo / BK, n_it = max(0, (k_hi + BK - 1) / BK - kt0);
  // K and V of iteration it into stage it & 1
  auto issue = [&](int it) {
    const int s = it & 1, k0 = (kt0 + it) * BK;
    if (!vec) {
      load_sw<HD, kTileRows, 128>(smem + (2 + 2 * s) * T, k_r, k0, Sk, hd);
      load_sw<HD, kTileRows, 128>(smem + (3 + 2 * s) * T, v_r, k0, Sk, hd);
    } else if (tid == 0) {
      const uint32_t b = bar + 8 * (1 + s);
      mbar_expect_tx(b, 2 * T);
      tma_tile<HD>(base + (2 + 2 * s) * T, &tm_k, k0, (int)kv_row, b);
      tma_tile<HD>(base + (3 + 2 * s) * T, &tm_v, k0, (int)kv_row, b);
    }
  };
  if (n_it > 0) issue(0);
  fence_proxy_async();
  __syncthreads();  // D, and element-wise copies of Q, dO and the first stage, are in
  const float da = sD[16 * wi + g], db = sD[16 * wi + g + 8];

  float acc[HD / 2];  // dQ: this warpgroup's 64 rows x HD
  zero(acc);
  const int w_lo = q0 + 16 * wi, w_hi = w_lo + 15;  // the warp's rows
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) issue(it + 1);  // the other stage, free since the last barrier
    if (vec) {
      mbar_wait(bar, 0);
      mbar_wait(bar + 8 * (1 + (it & 1)), (it >> 1) & 1);
    }
    const int k0 = (kt0 + it) * BK;
    const uint32_t sK = base + (2 + 2 * (it & 1)) * T, sV = sK + T;

    // S = Q K^T and dP = dO V^T: 64 rows x 64 keys
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kSlab + (kk & 3) * 32;
      wgmma_ss_n64<0>(s, sw128_desc(base + off, 16), sw128_desc(sK + off, 16), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kSlab + (kk & 3) * 32;
      wgmma_ss_n64<0>(dp, sw128_desc(base + T + off, 16), sw128_desc(sV + off, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    const bool inside = k0 + BK <= Sk && w_hi < Sq && (!causal || k0 + BK - 1 <= w_lo) &&
                        (window <= 0 || k0 > w_hi - window);
#pragma unroll
    for (int i = 0; i < 32; ++i)  // the weights first, independent of each other
      s[i] = exp2_ftz(s[i] * scale_log2 - ((i & 3) < 2 ? la : lb));
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int e = i & 3, qi = e < 2 ? qa : qb, kj = k0 + 8 * (i >> 2) + 2 * t4 + (e & 1);
      const bool ok = inside | pair_visible(qi, kj, Sq, Sk, causal, window);
      s[i] = ok ? s[i] * (dp[i] - (e < 2 ? da : db)) : 0.0f;  // dS
    }

    // dQ += dS K: dS (bf16) from registers, B the (64 keys, HD) K tile MN-major
    uint32_t a[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
    wgmma_fence();  // the A fragments were written by ordinary instructions
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_rs<HD, 1>(acc, a[kk], sw128_desc(sK + kk * 16 * 128, kSlab), 1);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    fence_proxy_async();
    __syncthreads();  // the stage is free; element-wise copies of the next are in
  }
  if (vec) mbar_wait(bar, 0);  // with no key tile, Q and dO are still landing

  __nv_bfloat16* dq_r = dq + (size_t)r * Sq * hd;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) {
    const int e = i & 3, row = e < 2 ? qa : qb, col = 8 * (i >> 2) + 2 * t4 + (e & 1);
    if (row < Sq && col < hd) dq_r[(size_t)row * hd + col] = __float2bfloat16_rn(acc[i] * scale);
  }
}

// ---- float32 on the CUDA cores ------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kF32Q = 32;  // q rows per tile of the dK/dV kernel, keys per tile of dQ

// row stride of an f32 tile in floats: a multiple of 4, and 4 mod 32, so the
// float4 reads of eight neighbouring rows fall in distinct banks
__host__ __device__ constexpr int f32_ld(int hd) {
  return (hd + 3) / 4 * 4 + ((4 - (hd + 3) / 4 * 4 % 32) + 32) % 32;
}

// rows [row0, row0 + rows) of a (rows, hd) f32 matrix into a (rows, ld)
// tile, zero past n_valid and, up to a multiple of 4, past hd
template <int NT>
__device__ __forceinline__ void load_f32(float* tile, const float* g, int row0, int rows,
                                         int n_valid, int hd, int ld, bool vec) {
  const int n4 = (hd + 3) / 4;
  for (int i = threadIdx.x; i < rows * n4; i += NT) {
    const int row = i / n4, c = (i % n4) * 4, grow = row0 + row;
    const uint32_t dst = smem_u32(tile + row * ld + c);
    const bool rok = grow < n_valid;
    const float* src = g + (rok ? (size_t)grow * hd + c : 0);
    if (vec) {
      cp_async16(dst, src, rok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cp_async4(dst + 4 * e, rok && c + e < hd ? src + e : g, rok && c + e < hd);
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}
__device__ __forceinline__ void axpy4(float4& y, float a, float4 x) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

// floats of the dK/dV kernel's shared memory: K and V (BK rows), two stages
// of (Q, dO, lse, D), P^T and dS^T (BK, 33); the partials (2, BK, HD + 4)
// after the loop reuse it
__host__ __device__ constexpr size_t dkdv_f32_floats(int BK, int HD, int ld) {
  return (size_t)2 * BK * ld + 2 * (2 * kF32Q * (size_t)ld + 2 * kF32Q) +
         2 * (size_t)BK * (kF32Q + 1);
}

template <int HD, int BK>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ d_o,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk,
                          int hd, int n_heads, int n_kv, int causal, int window, float scale,
                          long long n_kv_rows, int vec) {
  constexpr int BQ = kF32Q, KA = BK / 16, NC = HD / 64, LP = BQ + 1, PS = HD + 4;
  extern __shared__ float4 fsm4[];
  float* fsm = reinterpret_cast<float*>(fsm4);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const long long tile = blockIdx.x / C;
  const int k0 = (int)(tile / n_kv_rows) * BK;
  const long long kvr = tile % n_kv_rows;
  const long long bidx = kvr / n_kv;
  const int kvh = (int)(kvr % n_kv), group = n_heads / n_kv;
  const int h_lo = rank * group / C, h_hi = (rank + 1) * group / C;
  const int ld = f32_ld(hd), hd4 = (hd + 3) / 4 * 4;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float* sK = fsm;
  float* sV = sK + BK * ld;
  float* sStage = sV + BK * ld;  // stage s: Q, dO (BQ, ld), lse, D (BQ)
  const int stage_f = 2 * BQ * ld + 2 * BQ;
  float* sP = sStage + 2 * stage_f;  // P^T (BK, LP), then dS^T
  float* sS = sP + BK * LP;

  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + BK - 1 + window) : Sq;
  const int qt0 = q_lo / BQ, n_qt = max(0, (q_hi + BQ - 1) / BQ - qt0);
  const int n_it = (h_hi - h_lo) * n_qt;

  load_f32<kF32Threads>(sK, k + (size_t)kvr * Sk * hd, k0, BK, Sk, hd, ld, vec);
  load_f32<kF32Threads>(sV, v + (size_t)kvr * Sk * hd, k0, BK, Sk, hd, ld, vec);
  cp_async_commit();
  auto issue = [&](int it) {
    const long long r = bidx * n_heads + (long long)kvh * group + h_lo + it / n_qt;
    const int q0 = (qt0 + it % n_qt) * BQ;
    float* st = sStage + (it & 1) * stage_f;
    load_f32<kF32Threads>(st, q + (size_t)r * Sq * hd, q0, BQ, Sq, hd, ld, vec);
    load_f32<kF32Threads>(st + BQ * ld, d_o + (size_t)r * Sq * hd, q0, BQ, Sq, hd, ld, vec);
    if (tid < 2 * BQ) {
      const int i = tid & (BQ - 1);
      const bool ok = q0 + i < Sq;
      const float* src = (tid < BQ ? lse : delta) + (ok ? (size_t)r * Sq + q0 + i : 0);
      cp_async4(smem_u32(st + 2 * BQ * ld + tid), src, ok);
    }
  };
  if (n_it > 0) issue(0);
  cp_async_commit();

  float4 dva[KA][NC], dka[KA][NC];  // keys ty + 16a, columns 4tx + 64c ..
#pragma unroll
  for (int a = 0; a < KA; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dva[a][c] = dka[a][c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) issue(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = (qt0 + it % n_qt) * BQ;
    const float* sQ = sStage + (it & 1) * stage_f;
    const float* sdO = sQ + BQ * ld;
    const float* sL = sdO + BQ * ld;
    const float* sD = sL + BQ;

    // S^T and dP^T: keys ty + 16a against queries tx, tx + 16
    float s[KA][2], dp[KA][2];
#pragma unroll
    for (int a = 0; a < KA; ++a) s[a][0] = s[a][1] = dp[a][0] = dp[a][1] = 0.0f;
    for (int d = 0; d < hd4; d += 4) {
      const float4 qa = ld4(sQ + tx * ld + d), qb = ld4(sQ + (tx + 16) * ld + d);
      const float4 oa = ld4(sdO + tx * ld + d), ob = ld4(sdO + (tx + 16) * ld + d);
#pragma unroll
      for (int a = 0; a < KA; ++a) {
        const float4 kr = ld4(sK + (ty + 16 * a) * ld + d), vr = ld4(sV + (ty + 16 * a) * ld + d);
        s[a][0] = dot4(kr, qa, s[a][0]);
        s[a][1] = dot4(kr, qb, s[a][1]);
        dp[a][0] = dot4(vr, oa, dp[a][0]);
        dp[a][1] = dot4(vr, ob, dp[a][1]);
      }
    }
#pragma unroll
    for (int a = 0; a < KA; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int qc = tx + 16 * b;
        const bool ok = pair_visible(q0 + qc, k0 + ty + 16 * a, Sq, Sk, causal, window);
        const float e = expf(s[a][b] * scale - sL[qc]), p = ok ? e : 0.0f;
        sP[(ty + 16 * a) * LP + qc] = p;
        sS[(ty + 16 * a) * LP + qc] = p * (dp[a][b] - sD[qc]);
      }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q
    for (int i = 0; i < BQ; ++i) {
      float p[KA], ds[KA];
#pragma unroll
      for (int a = 0; a < KA; ++a) {
        p[a] = sP[(ty + 16 * a) * LP + i];
        ds[a] = sS[(ty + 16 * a) * LP + i];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = 4 * tx + 64 * c;
        if (col < hd4) {
          const float4 o = ld4(sdO + i * ld + col), qq = ld4(sQ + i * ld + col);
#pragma unroll
          for (int a = 0; a < KA; ++a) {
            axpy4(dva[a][c], p[a], o);
            axpy4(dka[a][c], ds[a], qq);
          }
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  float* part = fsm;  // (2, BK, PS): dV, then dK
#pragma unroll
  for (int a = 0; a < KA; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int row = ty + 16 * a, col = 4 * tx + 64 * c;
      *reinterpret_cast<float4*>(part + row * PS + col) = dva[a][c];
      *reinterpret_cast<float4*>(part + (BK + row) * PS + col) = dka[a][c];
    }
  cluster.sync();
  cluster_sum_store<float, HD>(cluster, part, BK, PS, dv + (size_t)kvr * Sk * hd,
                               dk + (size_t)kvr * Sk * hd, k0, Sk, hd, scale, vec);
  cluster.sync();
}

// floats of the dQ kernel's shared memory: Q and dO (BQ rows), two stages of
// (K, V) (32 rows), dS (BQ, 33), D (BQ)
__host__ __device__ constexpr size_t dq_f32_floats(int BQ, int ld) {
  return (size_t)2 * BQ * ld + 2 * (2 * kF32Q * (size_t)ld) + (size_t)BQ * (kF32Q + 2);
}

template <int HD, int BQ>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ d_o,
                        const float* __restrict__ o, const float* __restrict__ lse,
                        float* __restrict__ delta, float* __restrict__ dq, int Sq, int Sk, int hd, int n_heads, int n_kv,
                        int causal, int window, float scale, int n_qtiles, int vec) {
  constexpr int BK = kF32Q, QA = BQ / 16, NC = HD / 64, LS = BK + 1;
  extern __shared__ float4 fsm4[];
  float* fsm = reinterpret_cast<float*>(fsm4);
  const long long r = blockIdx.x / n_qtiles;
  const int q0 = (n_qtiles - 1 - (int)(blockIdx.x % n_qtiles)) * BQ;
  const long long kv_row = (r / n_heads) * n_kv + (r % n_heads) / (n_heads / n_kv);
  const float* k_r = k + (size_t)kv_row * Sk * hd;
  const float* v_r = v + (size_t)kv_row * Sk * hd;
  const int ld = f32_ld(hd), hd4 = (hd + 3) / 4 * 4;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float* sQ = fsm;
  float* sdO = sQ + BQ * ld;
  float* sStage = sdO + BQ * ld;  // stage s: K, V (BK, ld)
  float* sS = sStage + 4 * BK * ld;
  float* sD = sS + BQ * LS;

  load_f32<kF32Threads>(sQ, q + (size_t)r * Sq * hd, q0, BQ, Sq, hd, ld, vec);
  load_f32<kF32Threads>(sdO, d_o + (size_t)r * Sq * hd, q0, BQ, Sq, hd, ld, vec);
  cp_async_commit();
  {  // D of the tile's rows, kF32Threads / BQ threads a row, as the bf16 dQ kernel
    constexpr int kParts = kF32Threads / BQ;
    const int row = tid / kParts, part = tid % kParts;
    const float d = row_delta(o + (size_t)r * Sq * hd, d_o + (size_t)r * Sq * hd, q0 + row, Sq,
                              hd, part, kParts, vec);
    if (part == 0) {
      sD[row] = d;
      if (q0 + row < Sq) delta[(size_t)r * Sq + q0 + row] = d;
    }
  }
  float lr[QA];
#pragma unroll
  for (int a = 0; a < QA; ++a) {
    const int qi = q0 + ty + 16 * a;
    lr[a] = qi < Sq ? lse[(size_t)r * Sq + qi] : 0.0f;
  }
  const int k_hi = causal ? min(Sk, q0 + BQ) : Sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt0 = k_lo / BK, n_it = max(0, (k_hi + BK - 1) / BK - kt0);
  auto issue = [&](int it) {
    float* st = sStage + (it & 1) * 2 * BK * ld;
    load_f32<kF32Threads>(st, k_r, (kt0 + it) * BK, BK, Sk, hd, ld, vec);
    load_f32<kF32Threads>(st + BK * ld, v_r, (kt0 + it) * BK, BK, Sk, hd, ld, vec);
  };
  if (n_it > 0) issue(0);
  cp_async_commit();

  float4 acc[QA][NC];  // rows ty + 16a, columns 4tx + 64c ..
#pragma unroll
  for (int a = 0; a < QA; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();  // D is in
  float dr[QA];
#pragma unroll
  for (int a = 0; a < QA; ++a) dr[a] = sD[ty + 16 * a];
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) issue(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = (kt0 + it) * BK;
    const float* sK = sStage + (it & 1) * 2 * BK * ld;
    const float* sV = sK + BK * ld;

    // S and dP: rows ty + 16a against keys tx, tx + 16
    float s[QA][2], dp[QA][2];
#pragma unroll
    for (int a = 0; a < QA; ++a) s[a][0] = s[a][1] = dp[a][0] = dp[a][1] = 0.0f;
    for (int d = 0; d < hd4; d += 4) {
      const float4 ka = ld4(sK + tx * ld + d), kb = ld4(sK + (tx + 16) * ld + d);
      const float4 va = ld4(sV + tx * ld + d), vb = ld4(sV + (tx + 16) * ld + d);
#pragma unroll
      for (int a = 0; a < QA; ++a) {
        const float4 qr = ld4(sQ + (ty + 16 * a) * ld + d), orow = ld4(sdO + (ty + 16 * a) * ld + d);
        s[a][0] = dot4(qr, ka, s[a][0]);
        s[a][1] = dot4(qr, kb, s[a][1]);
        dp[a][0] = dot4(orow, va, dp[a][0]);
        dp[a][1] = dot4(orow, vb, dp[a][1]);
      }
    }
#pragma unroll
    for (int a = 0; a < QA; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int kc = tx + 16 * b;
        const bool ok = pair_visible(q0 + ty + 16 * a, k0 + kc, Sq, Sk, causal, window);
        const float e = expf(s[a][b] * scale - lr[a]), p = ok ? e : 0.0f;
        sS[(ty + 16 * a) * LS + kc] = p * (dp[a][b] - dr[a]);
      }
    __syncthreads();

    // dQ += dS K
    for (int j = 0; j < BK; ++j) {
      float ds[QA];
#pragma unroll
      for (int a = 0; a < QA; ++a) ds[a] = sS[(ty + 16 * a) * LS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = 4 * tx + 64 * c;
        if (col < hd4) {
          const float4 kk = ld4(sK + j * ld + col);
#pragma unroll
          for (int a = 0; a < QA; ++a) axpy4(acc[a][c], ds[a], kk);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int a = 0; a < QA; ++a) {
    const int qi = q0 + ty + 16 * a;
    if (qi >= Sq) continue;
    float* dq_r = dq + ((size_t)r * Sq + qi) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * tx + 64 * c;
      if (col < hd) {
        float4 x = acc[a][c];
        x.x *= scale;
        x.y *= scale;
        x.z *= scale;
        x.w *= scale;
        store4<float>(dq_r, x, col, hd, vec);
      }
    }
  }
}

// ---- launches -------------------------------------------------------------------

int check_args(int BH, int Sq, int Sk, int hd, int n_heads, int n_kv) {
  if (BH < 0 || Sq < 0 || Sk < 0 || hd < 1 || hd > kMaxHd || n_heads < 1 || n_kv < 1 ||
      n_heads % n_kv != 0 || BH % n_heads != 0)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// a launch of `kernel` on clusters of `cluster` CTAs along x
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), long long n_ctas, int threads,
                           size_t smem, int cluster, cudaStream_t st, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename... Params, typename... Args>
cudaError_t launch_plain(void (*kernel)(Params...), long long n_ctas, int threads, size_t smem,
                         cudaStream_t st, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)n_ctas), threads, smem, st>>>(args...);
  return cudaGetLastError();
}

// One backward's arguments; parts: 1 = dQ and D, 2 = dK/dV (both: 3).
struct Bwd {
  const void *q, *k, *v, *o, *d_o, *lse;
  void *delta, *dq, *dk, *dv;
  int BH, Sq, Sk, hd, n_heads, n_kv, causal, window;
  float scale;
  int parts;
  cudaStream_t st;
  int group() const { return n_heads / n_kv; }
  int cluster() const { return group() < kMaxCluster ? group() : kMaxCluster; }
  long long kv_rows() const { return (long long)BH / n_heads * n_kv; }
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, reached through the runtime (the library
// links no libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res) ==
            cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D (mats, rows, hd) bf16 tensor map of 64 x 64 boxes in the 128-byte
// swizzle; boxes past rows or hd fill with zeros.  Zeroed (unused) when the
// tensor is empty.
int tensor_map(CUtensorMap* map, const void* base, int hd, int rows, long long mats) {
  *map = CUtensorMap{};
  if (rows == 0 || mats == 0) return 0;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)rows, (cuuint64_t)mats};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)rows * hd * 2};
  const cuuint32_t box[3] = {64, 64, 1}, unit[3] = {1, 1, 1};
  const CUresult r =
      enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
          unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD>
int launch_bwd_bf16(const Bwd& a, int vec) {
  using bf = __nv_bfloat16;
  const int n_ktiles = (a.Sk + kTileRows - 1) / kTileRows;
  const int n_qtiles = (a.Sq + kTileRows - 1) / kTileRows;
  const long long n_kv_ctas = a.kv_rows() * n_ktiles * a.cluster();
  const long long n_q_ctas = (long long)a.BH * n_qtiles;
  if (n_kv_ctas > kMaxGridX || n_q_ctas > kMaxGridX) return (int)cudaErrorInvalidConfiguration;
  const bf *q = static_cast<const bf*>(a.q), *k = static_cast<const bf*>(a.k),
           *v = static_cast<const bf*>(a.v), *d_o = static_cast<const bf*>(a.d_o);
  const float* lse = static_cast<const float*>(a.lse);
  float* delta = static_cast<float*>(a.delta);
  CUtensorMap tm_q{}, tm_k{}, tm_v{}, tm_do{};
  if (vec) {  // whole 16-byte rows, aligned: the tiles arrive by TMA
    // the encoder needs the device's context current on this thread, which a
    // thread that has made no runtime call yet (autograd's) lacks
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaSetDevice(dev);
    if (err != cudaSuccess) return (int)err;
    if (int rc = tensor_map(&tm_q, q, a.hd, a.Sq, a.BH)) return rc;
    if (int rc = tensor_map(&tm_do, d_o, a.hd, a.Sq, a.BH)) return rc;
    if (int rc = tensor_map(&tm_k, k, a.hd, a.Sk, a.kv_rows())) return rc;
    if (int rc = tensor_map(&tm_v, v, a.hd, a.Sk, a.kv_rows())) return rc;
  }
  if ((a.parts & 1) && n_q_ctas > 0) {  // dQ, and D for dK/dV
    cudaError_t err = launch_plain(
        flash_bwd_dq_bf16_kernel<HD>, n_q_ctas, 128, dq_smem<HD>(), a.st, tm_q, tm_k, tm_v,
        tm_do, q, k, v, d_o, static_cast<const bf*>(a.o), lse, delta, static_cast<bf*>(a.dq),
        a.Sq, a.Sk, a.hd, a.n_heads, a.n_kv, a.causal, a.window, a.scale, n_qtiles, vec);
    if (err != cudaSuccess) return (int)err;
  }
  if ((a.parts & 2) && n_kv_ctas > 0) {
    cudaError_t err = launch_cluster(
        flash_bwd_dkdv_bf16_kernel<HD>, n_kv_ctas, 256, dkdv_smem<HD>(), a.cluster(), a.st,
        tm_q, tm_k, tm_v, tm_do, q, k, v, d_o, lse, static_cast<const float*>(delta),
        static_cast<bf*>(a.dk), static_cast<bf*>(a.dv), a.Sq, a.Sk, a.hd, a.n_heads, a.n_kv,
        a.causal, a.window, a.scale, a.kv_rows(), vec);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <int HD, int BK, int BQ>
int launch_bwd_f32_tiles(const Bwd& a, int vec) {
  const int n_ktiles = (a.Sk + BK - 1) / BK, n_qtiles = (a.Sq + BQ - 1) / BQ;
  const long long n_kv_ctas = a.kv_rows() * n_ktiles * a.cluster();
  const long long n_q_ctas = (long long)a.BH * n_qtiles;
  if (n_kv_ctas > kMaxGridX || n_q_ctas > kMaxGridX) return (int)cudaErrorInvalidConfiguration;
  const int ld = f32_ld(a.hd);
  const float *q = static_cast<const float*>(a.q), *k = static_cast<const float*>(a.k),
              *v = static_cast<const float*>(a.v), *d_o = static_cast<const float*>(a.d_o);
  const float* lse = static_cast<const float*>(a.lse);
  float* delta = static_cast<float*>(a.delta);
  if ((a.parts & 1) && n_q_ctas > 0) {  // dQ, and D for dK/dV
    const size_t smem = sizeof(float) * dq_f32_floats(BQ, ld);
    cudaError_t err = launch_plain(
        flash_bwd_dq_f32_kernel<HD, BQ>, n_q_ctas, kF32Threads, smem, a.st, q, k, v, d_o,
        static_cast<const float*>(a.o), lse, delta, static_cast<float*>(a.dq), a.Sq, a.Sk, a.hd,
        a.n_heads, a.n_kv, a.causal, a.window, a.scale, n_qtiles, vec);
    if (err != cudaSuccess) return (int)err;
  }
  if ((a.parts & 2) && n_kv_ctas > 0) {
    const size_t main_f = dkdv_f32_floats(BK, HD, ld), part_f = (size_t)2 * BK * (HD + 4);
    const size_t smem = sizeof(float) * (main_f > part_f ? main_f : part_f);
    cudaError_t err = launch_cluster(
        flash_bwd_dkdv_f32_kernel<HD, BK>, n_kv_ctas, kF32Threads, smem, a.cluster(), a.st, q,
        k, v, d_o, lse, static_cast<const float*>(delta), static_cast<float*>(a.dk),
        static_cast<float*>(a.dv), a.Sq, a.Sk, a.hd, a.n_heads, a.n_kv, a.causal, a.window,
        a.scale, a.kv_rows(), vec);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// key tiles (dK/dV) and q tiles (dQ) of 16 where 32 would give fewer than
// two CTAs an SM
template <int HD>
int launch_bwd_f32(const Bwd& a, int vec) {
  const bool small_k = a.kv_rows() * ((a.Sk + 31) / 32) * a.cluster() < 2 * kSMs;
  const bool small_q = (long long)a.BH * ((a.Sq + 31) / 32) < 2 * kSMs;
  if (small_k && small_q) return launch_bwd_f32_tiles<HD, 16, 16>(a, vec);
  if (small_k) return launch_bwd_f32_tiles<HD, 16, 32>(a, vec);
  if (small_q) return launch_bwd_f32_tiles<HD, 32, 16>(a, vec);
  return launch_bwd_f32_tiles<HD, 32, 32>(a, vec);
}

uintptr_t ptr_bits(const Bwd& a) {
  return reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
         reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.d_o) |
         reinterpret_cast<uintptr_t>(a.o) | reinterpret_cast<uintptr_t>(a.dq) | reinterpret_cast<uintptr_t>(a.dk) |
         reinterpret_cast<uintptr_t>(a.dv);
}

}  // namespace

extern "C" {

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// parts: 1 = dQ (which also writes D), 2 = dK/dV (which reads D); the
// wrapper passes 3 (a part alone is for timing)
int flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                             const void* d_o, const void* lse, void* delta, void* dq, void* dk,
                             void* dv, int BH, int Sq, int Sk, int hd, int n_heads, int n_kv,
                             int causal, int window, float scale, int parts, void* stream) {
  if (int rc = check_args(BH, Sq, Sk, hd, n_heads, n_kv)) return rc;
  if (BH == 0) return 0;
  const Bwd a{q,  k,      v,    o,      d_o,    lse,   delta, dq,
              dk, dv,     BH,   Sq,     Sk,     hd,    n_heads, n_kv,
              causal, window, scale, parts, static_cast<cudaStream_t>(stream)};
  // 16-byte copies need rows of whole 16-byte chunks and aligned tensors
  const int vec = hd % 8 == 0 && ptr_bits(a) % 16 == 0;
  if (hd <= 64) return launch_bwd_bf16<64>(a, vec);
  if (hd <= 128) return launch_bwd_bf16<128>(a, vec);
  return launch_bwd_bf16<256>(a, vec);
}

int flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                            const void* d_o, const void* lse, void* delta, void* dq, void* dk,
                            void* dv, int BH, int Sq, int Sk, int hd, int n_heads, int n_kv,
                            int causal, int window, float scale, int parts, void* stream) {
  if (int rc = check_args(BH, Sq, Sk, hd, n_heads, n_kv)) return rc;
  if (BH == 0) return 0;
  const Bwd a{q,  k,      v,    o,      d_o,    lse,   delta, dq,
              dk, dv,     BH,   Sq,     Sk,     hd,    n_heads, n_kv,
              causal, window, scale, parts, static_cast<cudaStream_t>(stream)};
  const int vec = hd % 4 == 0 && ptr_bits(a) % 16 == 0;
  if (hd <= 64) return launch_bwd_f32<64>(a, vec);
  if (hd <= 128) return launch_bwd_f32<128>(a, vec);
  return launch_bwd_f32<256>(a, vec);
}

}  // extern "C"
