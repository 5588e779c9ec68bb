// Mamba2 SSD chunked scan for the H100 (sm_90a), float32, chunk-parallel.
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
// What bounds it on this card: operations.  B and C have one group, so C B^T
// (its causal triangle, Q(Q+1)/2 x N a chunk) is shared by all heads; each
// head adds the masked product with x (Q(Q+1)/2 x P) and the state's read
// and update (2 x Q x N x P).  At mamba2-130m's prefill (B=4, H=24, S=4096,
// Q=64, N=128, P=64) that is 14.7 GFLOP (0.22 ms at the 67 TFLOP/s float32
// rate) against 220 MB moved (0.07 ms); the kernels compute whole Q x Q
// tiles and mask them.  The products stay float32 FMAs: TF32's rounding of each input
// (~5e-4) would break the 1e-4 chunk invariance.
//
// Design.  The TPU kernel carries the state in VMEM across a sequential grid
// (b, h, chunk); a CUDA grid has no order, and one CTA walking all of one
// (b, h)'s chunks (the first port) left 36 of 132 SMs idle at B * H = 96,
// synced 4-5 times a chunk and computed C B^T once per head.  The entry
// splits the work in the order of sums of the plain version ssd_chunked
// (models/ssd.py) and launches three kernels in order on the caller's
// stream, through scratch the wrapper allocates:
//   0. ssd_scan_kernel, one warp per (b, h, chunk): L, the weights
//      w_t = exp(L_Q - L_t) dt_t and the decay exp(L_Q) (B * H * (2S + nc)
//      floats).
//   1. ssd_state_kernel, one CTA per (b, h, 32 rows of N): walks the chunks
//      in order with its (32, P) slice of the state in registers, writes the
//      state entering each chunk, S_in (B, H, nc, N, P), and adds the
//      chunk's own (B * w)^T x.  The next chunk's B, x and w are copied in
//      with cp.async while the current one is used, so only the carry is in
//      order: 384 CTAs at the main shape, and no round trip of per-chunk
//      partial states through device memory (a per-chunk state kernel and a
//      separate carry pass moved 4 x 201 MB of scratch).
//   2. ssd_out_kernel, one CTA per (b, chunk, group of kHeads heads), all
//      chunks in parallel: C B^T once into shared memory for the group, then
//      per head the masked scores ((C B^T) * exp(seg)), 64 rows at a time,
//      and y = scores (dt * x) + (C S_in) * exp(L).
// Every product is tiled 4 x 4 a thread with float4 reads of shared memory,
// four steps of the sum at a time; rows that a warp reads down a column are
// XOR-swizzled by 16-byte chunk, so those reads are free of bank conflicts.
// Global memory is read in float4s where N, P and Q are multiples of 4 and
// the tensors are 16-byte aligned, else element by element.
// At Q = 128 the output kernel's C, B (then dt * x and S_in), C B^T and one
// 64-row block of scores take 229,888 B of the 232,448 a block can have; at
// Q = 64, 114,944 B, so two CTAs share an SM.  No atomics: every run gives
// the same bits.
//
// The backward, entry ssd_chunk_bwd (#9b; no TPU kernel: the reference takes
// this gradient by XLA's autodiff of ssd_chunked).  With G_c the gradient of
// the state leaving chunk c, it is written from the math (the formulas at
// ssd_grad_kernel).  Four launches in order: the forward's scan (also
// exp(L)); both state walks in one launch (ssd_walks_kernel: S_in forward,
// G in reverse; all 384 CTAs resident at mamba2-130m's training shape); the
// gradient kernel, one CTA of 8 warps per (b, chunk) over every head; and
// da's sum per head.  db and dc sum over the heads inside each CTA, da in a
// fixed order: no atomics, the same bits every run.
//
// Every product runs on the tensor cores in 3xTF32 (mma.sync m16n8k8; the
// split at Frag): TF32 alone rounds each input to 2^-11 and would break the
// gradient's 1e-4 chunk invariance, while three TF32 products keep each one
// within ~1e-6 of float32.  What bounds it: at mamba2-130m's training shape
// (B=4, H=24, S=4096, Q=64, N=128, P=64) the gradient needs 42.5 GFLOP of
// float32 work (causal triangles): 0.26 ms as 3 x TF32 at 495 TFLOP/s, the
// route's bound (0.63 ms at the 67 TFLOP/s CUDA-core rate), against 336 MB of
// inputs and outputs (0.10 ms) and an 805 MB round trip of S_in and G through
// scratch.  On the card the kernels are bound by the instructions around
// the MMAs (loads, the split, addresses; two warps a scheduler in the
// gradient kernel) and the walks by that round trip (PERF.md).  What the
// design does about the first port's limits:
//   - products on the CUDA cores with scalar shared-memory operands: MMA
//     fragments, read without bank conflicts (padded or XOR-swizzled tiles)
//     and split in registers;
//   - copies that blocked the math (each head's 96 KB through registers,
//     then a barrier): a ring of four slots filled by cp.async while earlier
//     heads compute, each refilled as soon as its last reader is done;
//   - wasted work: only the 20 16 x 8 tiles of each Q x Q triangle that hold
//     some s >= t; the dL term exp(L_s) C_s . (S_in dy_s) a dot with the
//     dy S_in^T that dc needs anyway; and, B and C being one group, the head
//     sums of db's W^T C and dc's W B taken once a chunk on sum_h W_h: 1,856
//     MMA tiles (1,024 multiply-adds each) a head and chunk outside the
//     walks, where the gradient's count (chip_smoke.py) takes 2,340;
//   - one CTA of 8 warps an SM: still so (231,984 B of shared memory, 251
//     registers), the 256 CTAs two waves over 132 SMs; the serial tail of a
//     head (dL's suffix sums) now runs on one warp while the others start
//     the next head.  Two CTAs an SM would have 113 KB each, and B, C and
//     A^T alone take 80 KB: no room for one 34 KB ring slot.  The grid's
//     other splits were slower on the card (tools/ssd_bwd_design.py grid;
//     PERF.md): 16 warps, at most 128 registers a thread (84 B spilled),
//     0.816 ms for the gradient kernel against 0.779; two CTAs per (b,
//     chunk) of 12 heads each, the CTAs of a cluster over head groups but
//     without even the sum of their db and dc, 0.903 ms: each CTA still
//     holds the whole layout, so an SM still runs one, and each repeats
//     C B^T, the B and C copies and the head-sum products.
// The gradient kernel works at chunks of at most 64 (kGQ); the wrapper
// halves a longer chunk, which changes only the order of sums.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // output kernel: 16 x 16
constexpr int kStateThreads = 128; // state kernel: 8 x 16
constexpr int kMaxQ = 128;         // the L scan: one warp, four steps a lane
constexpr int kMaxN = 128;
constexpr int kMaxP = 64;          // columns tx * 4 + j, tx < 16, j < 4
constexpr int kNT = 32;            // state rows per CTA of the state kernel
constexpr int kRows = 64;          // rows of s per pass over the masked scores
constexpr int kHeads = 4;          // heads per CTA of the output kernel
constexpr int kSmemMax = 232448;   // 227 KB, the most a block can opt into

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Offset of (row, col) in a row-major tile whose rows are ld floats (ld a
// multiple of 32), its 16-byte chunks XOR-swizzled by row & 7.
__device__ __forceinline__ int sw4(int row, int col, int ld) {
  return row * ld + ((((col >> 2) ^ (row & 7)) << 2) | (col & 3));
}

// L = cumsum(dt * a) over a chunk of Q <= 128 steps, by one warp: four steps
// a lane, then a warp scan; lane l returns its four steps in v
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dt_c, float ah, int Q,
                                             float (&v)[4]) {
  const int lane = threadIdx.x & 31;
  float run = 0.0f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int t = lane * 4 + u;
    run += (t < Q) ? dt_c[t] * ah : 0.0f;
    v[u] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const float excl = incl - run;
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] += excl;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// 0. Per chunk of one (b, h): L = cumsum(dt * a), w_t = exp(L_Q - L_t) dt_t
// and the decay exp(L_Q); one warp a chunk.  The backward also takes
// exp(L_t) (ez), the weights of its reverse state walk.
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ dt, const float* __restrict__ a,
                float* __restrict__ lcum, float* __restrict__ w, float* __restrict__ decay,
                float* __restrict__ ez, int H, int S, int Q, int nc, long long n_warps) {
  const long long wid = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (wid >= n_warps) return;  // whole warps only
  const long long bh = wid / nc;
  const int c = (int)(wid % nc), lane = threadIdx.x & 31;
  const size_t off = (size_t)bh * S + (size_t)c * Q;
  float v[4];
  chunk_cumsum(dt + off, a[bh % H], Q, v);
  const int u_last = (Q - 1) & 3;
  const float last = u_last == 0 ? v[0] : u_last == 1 ? v[1] : u_last == 2 ? v[2] : v[3];
  const float lq = __shfl_sync(0xffffffffu, last, (Q - 1) >> 2);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int t = lane * 4 + u;
    if (t < Q) {
      lcum[off + t] = v[u];
      w[off + t] = expf(lq - v[u]) * dt[off + t];
      if (ez != nullptr) ez[off + t] = expf(v[u]);  // the backward's weights
    }
  }
  if (lane == 0) decay[bh * nc + c] = expf(lq);
}

__host__ __device__ constexpr int state_stage_floats(int Q, int P) {
  return round_up(Q, 4) * (kNT + round_up(P, 4) + 1);  // B, x, w
}

// 1. The state entering every chunk, in order over the chunks.  The
// backward's ssd_walks_kernel computes the same states on 3xTF32 MMAs, but
// for #9 its forward blocks alone (192 CTAs of 64 state rows at mamba2-130m's
// prefill) were slower than these 384 of 32: 0.295 ms against 0.268
// (tools/ssd_bwd_design.py forward), so the forward keeps its own walk.
__global__ void __launch_bounds__(kStateThreads)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                 const float* __restrict__ w, const float* __restrict__ decay,
                 float* __restrict__ s_in, int H, int S, int P, int N, int Q, int nc,
                 int n_tiles, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int ldx = round_up(P, 4), qp = round_up(Q, 4), stage = state_stage_floats(Q, P);
  const int nt = blockIdx.x % n_tiles;
  const long long bh = blockIdx.x / n_tiles;
  const int bi = (int)(bh / H);
  const int n0 = nt * kNT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* x_bh = x + (size_t)bh * S * P;
  const float* w_bh = w + (size_t)bh * S;
  const float* b_b = bm + (size_t)bi * S * N;

  // stage s holds B[:, n0:n0+32] (qp, kNT), x (qp, ldx), w (qp); rows past
  // Q, columns past N or P are zero and stay so
  for (int st = 0; st < 2; ++st) {
    float* base = smem + st * stage;
    for (int i = tid; i < (qp - Q) * kNT; i += kStateThreads) base[Q * kNT + i] = 0.0f;
    for (int i = tid; i < (qp - Q) * ldx; i += kStateThreads)
      base[qp * kNT + Q * ldx + i] = 0.0f;
    for (int i = Q + tid; i < qp; i += kStateThreads) base[qp * (kNT + ldx) + i] = 0.0f;
  }
  auto load = [&](int c, int buf) {
    float* sB = smem + buf * stage;
    float* sX = sB + qp * kNT;
    float* sW = sX + qp * ldx;
    const size_t t0 = (size_t)c * Q;
    if (vec) {
      for (int i = tid; i < Q * (kNT / 4); i += kStateThreads) {
        const int t = i / (kNT / 4), n = (i % (kNT / 4)) * 4;
        if (n0 + n < N)
          cp_async16(sB + t * kNT + n, b_b + (t0 + t) * N + n0 + n);
        else
          *reinterpret_cast<float4*>(sB + t * kNT + n) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int i = tid; i < Q * (P / 4); i += kStateThreads)
        cp_async16(sX + i * 4, x_bh + t0 * P + i * 4);  // ldx == P
      for (int i = tid; i < Q / 4; i += kStateThreads) cp_async16(sW + i * 4, w_bh + t0 + i * 4);
    } else {
      for (int i = tid; i < Q * kNT; i += kStateThreads) {
        const int t = i / kNT, n = i % kNT;
        if (n0 + n < N)
          cp_async4(sB + i, b_b + (t0 + t) * N + n0 + n);
        else
          sB[i] = 0.0f;
      }
      for (int i = tid; i < Q * ldx; i += kStateThreads) {
        const int t = i / ldx, p = i % ldx;
        if (p < P)
          cp_async4(sX + i, x_bh + (t0 + t) * P + p);
        else
          sX[i] = 0.0f;
      }
      for (int i = tid; i < Q; i += kStateThreads) cp_async4(sW + i, w_bh + t0 + i);
    }
  };

  float st[4][4];  // the state rows n0 + ty*4 + i, columns tx*4 + j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) st[i][j] = 0.0f;
  __syncthreads();  // the zero padding is written before the copies land
  load(0, 0);
  cp_async_commit();
  const bool active = n0 + ty * 4 < N && tx * 4 < P;
  for (int k = 0; k < nc; ++k) {
    const int c = k;
    if (k + 1 < nc) load(c + 1, (k + 1) & 1);
    cp_async_commit();
    const float dq = decay[bh * nc + c];
    cp_async_wait1();
    __syncthreads();
    if (active) {
      const float* sB = smem + (k & 1) * stage;
      const float* sX = sB + qp * kNT;
      const float* sW = sX + qp * ldx;
      float* out = s_in + (((size_t)bh * nc + c) * N + n0 + ty * 4) * P + tx * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (n0 + ty * 4 + i >= N) continue;
        if (vec) {
          *reinterpret_cast<float4*>(out + (size_t)i * P) =
              make_float4(st[i][0], st[i][1], st[i][2], st[i][3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (tx * 4 + j < P) out[(size_t)i * P + j] = st[i][j];
        }
      }
      float up[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) up[i][j] = 0.0f;
      for (int t = 0; t < qp; t += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(sW + t);
        const float ws[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 bv = *reinterpret_cast<const float4*>(sB + (t + u) * kNT + ty * 4);
          const float4 xv = *reinterpret_cast<const float4*>(sX + (t + u) * ldx + tx * 4);
          const float bs[4] = {bv.x * ws[u], bv.y * ws[u], bv.z * ws[u], bv.w * ws[u]};
          const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) up[i][j] = fmaf(bs[i], xs[j], up[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = st[i][j] * dq + up[i][j];
    }
    __syncthreads();  // stage k & 1 is refilled by the next iteration's load
  }
}

// the output kernel's shared memory, in floats
struct OutLayout {
  int qr, ldc, lda, ldx, np, qp, region, total;
  __host__ __device__ OutLayout(int Q, int N, int P) {
    qr = round_up(Q, kRows);  // rows of C and B
    ldc = round_up(N, 32);    // C, B rows (swizzled)
    lda = round_up(Q, 32);    // score rows (swizzled)
    ldx = round_up(P, 4);     // dt * x and S_in rows
    np = round_up(N, 4);      // rows of S_in
    qp = round_up(Q, 4);      // rows of dt * x, C B^T row stride
    region = qr * ldc > (qp + np) * ldx ? qr * ldc : (qp + np) * ldx;
    total = qr * ldc + region + Q * qp + kRows * lda + Q;
  }
};

// 2. y for one (b, chunk) and up to kHeads heads, C B^T computed once.
__global__ void __launch_bounds__(kThreads)
ssd_out_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ bm, const float* __restrict__ cm,
               const float* __restrict__ lcum, const float* __restrict__ s_in,
               float* __restrict__ y, int H, int S, int P, int N, int Q, int nc,
               int n_groups, int vec) {
  extern __shared__ __align__(16) float smem[];
  const OutLayout lay(Q, N, P);
  const int ldc = lay.ldc, lda = lay.lda, ldx = lay.ldx, qp = lay.qp;
  float* sC = smem;                  // (qr, ldc) swizzled
  float* sR = sC + lay.qr * ldc;     // B (qr, ldc) for C B^T, then per head:
  float* sX = sR;                    //   (qp, ldx): dt * x
  float* sS = sR + qp * ldx;         //   (np, ldx): the state entering the chunk
  float* sCB = sR + lay.region;      // (Q, qp): C B^T, columns t <= s
  float* sAtt = sCB + Q * qp;        // (kRows, lda) swizzled: one row block
  float* sL = sAtt + kRows * lda;    // (Q): L

  const int gi = blockIdx.x % n_groups;
  const long long bc = blockIdx.x / n_groups;
  const int c = (int)(bc % nc), bi = (int)(bc / nc);
  const size_t t0 = (size_t)c * Q;
  const float* b_c = bm + ((size_t)bi * S + t0) * N;
  const float* c_c = cm + ((size_t)bi * S + t0) * N;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  {  // C and B: 32 threads a row, a float4 each
    const int n = (tid & 31) * 4;
    if (n < ldc) {
      for (int t = tid >> 5; t < lay.qr; t += kThreads / 32) {
        float4 cv = make_float4(0.f, 0.f, 0.f, 0.f), bv = cv;
        if (t < Q && n < N) {
          const float* cr = c_c + (size_t)t * N + n;
          const float* br = b_c + (size_t)t * N + n;
          if (vec) {
            cv = *reinterpret_cast<const float4*>(cr);
            bv = *reinterpret_cast<const float4*>(br);
          } else {
            cv.x = cr[0], bv.x = br[0];
            if (n + 1 < N) cv.y = cr[1], bv.y = br[1];
            if (n + 2 < N) cv.z = cr[2], bv.z = br[2];
            if (n + 3 < N) cv.w = cr[3], bv.w = br[3];
          }
        }
        *reinterpret_cast<float4*>(sC + sw4(t, n, ldc)) = cv;
        *reinterpret_cast<float4*>(sR + sw4(t, n, ldc)) = bv;
      }
    }
  }
  __syncthreads();
  // C B^T on the 64 x 64 blocks on or below the diagonal: rows s0 + ty + 16i,
  // columns tb + tx + 16j
  for (int s0 = 0; s0 < Q; s0 += kRows) {
    for (int tb = 0; tb <= s0; tb += kRows) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      for (int n = 0; n < lay.np; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cv[i] = *reinterpret_cast<const float4*>(sC + sw4(s0 + ty + 16 * i, n, ldc));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = *reinterpret_cast<const float4*>(sR + sw4(tb + tx + 16 * j, n, ldc));
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(cv[i].w, bv[j].w,
                             fmaf(cv[i].z, bv[j].z,
                                  fmaf(cv[i].y, bv[j].y, fmaf(cv[i].x, bv[j].x, acc[i][j]))));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = s0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = tb + tx + 16 * j;
          if (s < Q && t < Q) sCB[s * qp + t] = acc[i][j];
        }
      }
    }
  }

  const bool active = tx * 4 < P;  // this thread's columns tx*4 + j
  const int h_end = min(H, (gi + 1) * kHeads);
  for (int h = gi * kHeads; h < h_end; ++h) {
    __syncthreads();  // C B^T is written; the previous head's reads are done
    const long long bh = (long long)bi * H + h;
    const float* x_c = x + ((size_t)bh * S + t0) * P;
    const float* dt_c = dt + (size_t)bh * S + t0;
    const float* s_c = s_in + ((size_t)bh * nc + c) * N * P;
    {  // dt * x and S_in: 16 threads a row, a float4 each
      const int p = tx * 4;
      if (p < ldx) {
        for (int t = ty; t < qp; t += kThreads / 16) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (t < Q && p < P) {
            const float* xr = x_c + (size_t)t * P + p;
            const float d = dt_c[t];
            if (vec) {
              v = *reinterpret_cast<const float4*>(xr);
            } else {
              v.x = xr[0];
              if (p + 1 < P) v.y = xr[1];
              if (p + 2 < P) v.z = xr[2];
              if (p + 3 < P) v.w = xr[3];
            }
            v = make_float4(v.x * d, v.y * d, v.z * d, v.w * d);
          }
          *reinterpret_cast<float4*>(sX + t * ldx + p) = v;
        }
        for (int n = ty; n < lay.np; n += kThreads / 16) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (n < N && p < P) {
            const float* sr = s_c + (size_t)n * P + p;
            if (vec) {
              v = *reinterpret_cast<const float4*>(sr);
            } else {
              v.x = sr[0];
              if (p + 1 < P) v.y = sr[1];
              if (p + 2 < P) v.z = sr[2];
              if (p + 3 < P) v.w = sr[3];
            }
          }
          *reinterpret_cast<float4*>(sS + n * ldx + p) = v;
        }
      }
    }
    for (int t = tid; t < Q; t += kThreads) sL[t] = lcum[(size_t)bh * S + t0 + t];
    __syncthreads();

    for (int s0 = 0; s0 < Q; s0 += kRows) {
      const int t_end = min(Q, s0 + kRows);  // t <= s < s0 + kRows
      const int t_pad = round_up(t_end, 4);
      {  // the masked scores of rows s0..s0+63: 4 threads a row, 4 columns each
        const int row = tid >> 2, s = s0 + row;
        const float ls = s < Q ? sL[s] : 0.0f;
        for (int t = (tid & 3) * 4; t < t_pad; t += 16) {
          float v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int tt = t + u;
            v[u] = (s < Q && tt <= s) ? sCB[s * qp + tt] * expf(ls - sL[tt]) : 0.0f;
          }
          *reinterpret_cast<float4*>(sAtt + sw4(row, t, lda)) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
      __syncthreads();

      if (active) {
        float yi[4][4], ys[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) yi[i][j] = ys[i][j] = 0.0f;
        for (int t = 0; t < t_pad; t += 4) {
          float4 av[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            av[i] = *reinterpret_cast<const float4*>(sAtt + sw4(ty + 16 * i, t, lda));
#pragma unroll
          for (int u = 0; u < 4; ++u)
            xv[u] = *reinterpret_cast<const float4*>(sX + (t + u) * ldx + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float ar[4] = {av[i].x, av[i].y, av[i].z, av[i].w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              yi[i][0] = fmaf(ar[u], xv[u].x, yi[i][0]);
              yi[i][1] = fmaf(ar[u], xv[u].y, yi[i][1]);
              yi[i][2] = fmaf(ar[u], xv[u].z, yi[i][2]);
              yi[i][3] = fmaf(ar[u], xv[u].w, yi[i][3]);
            }
          }
        }
        for (int n = 0; n < lay.np; n += 4) {
          float4 cv[4], sv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            cv[i] = *reinterpret_cast<const float4*>(sC + sw4(s0 + ty + 16 * i, n, ldc));
#pragma unroll
          for (int u = 0; u < 4; ++u)
            sv[u] = *reinterpret_cast<const float4*>(sS + (n + u) * ldx + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float cr[4] = {cv[i].x, cv[i].y, cv[i].z, cv[i].w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              ys[i][0] = fmaf(cr[u], sv[u].x, ys[i][0]);
              ys[i][1] = fmaf(cr[u], sv[u].y, ys[i][1]);
              ys[i][2] = fmaf(cr[u], sv[u].z, ys[i][2]);
              ys[i][3] = fmaf(cr[u], sv[u].w, ys[i][3]);
            }
          }
        }
        float* y_c = y + ((size_t)bh * S + t0) * P;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int s = s0 + ty + 16 * i;
          if (s >= Q) continue;
          const float el = expf(sL[s]);
          float* yo = y_c + (size_t)s * P + tx * 4;
          if (vec) {
            *reinterpret_cast<float4*>(yo) =
                make_float4(yi[i][0] + ys[i][0] * el, yi[i][1] + ys[i][1] * el,
                            yi[i][2] + ys[i][2] * el, yi[i][3] + ys[i][3] * el);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (tx * 4 + j < P) yo[j] = yi[i][j] + ys[i][j] * el;
          }
        }
      }
      __syncthreads();  // sAtt is refilled after this
    }
  }
}

// ---- the backward ---------------------------------------------------------

constexpr int kGQ = 64;               // most rows of a chunk in the gradient kernel
constexpr int kLd = kMaxP + 4;        // row stride of x, dy, S_in and G in a ring slot
constexpr int kSlot = kMaxN * kLd;    // one ring slot: S_in or G, or x then dy
constexpr int kRing = 4;              // slots: a head's x/dy, G and S_in, the next x/dy
constexpr int kTiles = 20;            // 16 x 8 tiles of a Q x Q triangle (s >= t)
constexpr int kWalkRows = 64;         // state rows per CTA of the backward's walks
constexpr int kWalkLd = kWalkRows + 8;  // row stride of their B and x tiles
constexpr int kWalkStage = 2 * kGQ * kWalkLd + kGQ;  // floats: B, x, w

// the gradient kernel's shared memory, in floats: one fixed layout at the
// largest shapes (Q = 64, N = 128, P = 64), rows and columns past Q, N or P
// zero.  B, C and A^T are XOR-swizzled (swz), the ring's tiles padded to kLd.
struct GradLayout {
  static constexpr int ring = 0;                     // kRing slots of kSlot
  static constexpr int b = ring + kRing * kSlot;     // B (kGQ, kMaxN)
  static constexpr int c = b + kGQ * kMaxN;          // C (kGQ, kMaxN)
  static constexpr int at = c + kGQ * kMaxN;         // A^T (kGQ, kGQ): rows t, columns s
  static constexpr int vec = at + kGQ * kGQ;         // 3 heads' 6 vectors (vecs below)
  static constexpr int rowp = vec + 3 * 6 * kGQ;     // (8, kGQ) M^T row sums by s block
  static constexpr int colp = rowp + 8 * kGQ;        // (4, kGQ) M^T column sums by t strip
  static constexpr int xgp = colp + 4 * kGQ;         // (4, kGQ) x . g by column quarter
  static constexpr int rp = xgp + 4 * kGQ;           // (4, kGQ) x . (B G) by column quarter
  static constexpr int ip = rp + 4 * kGQ;            // (4, kGQ) C . (dy S_in^T) by quarter
  static constexpr int red = ip + 4 * kGQ;           // 8 warps' <S_in, G>
  static constexpr int last = red + kThreads / 32;   // dL's last-step terms: 3
  static constexpr int total = last + 4;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// (row, col) of a row-major tile of ld floats (ld a multiple of 32) whose
// 8-float groups are XOR-swizzled by row & 3: a warp's float2 reads of an
// MMA fragment, rows g and columns 2 tg (below), hit 32 distinct banks
__device__ __forceinline__ int swz(int row, int col, int ld) {
  return row * ld + (col ^ ((row & 3) << 3));
}

// cp.async of 16 or 4 bytes that fills the rest of the destination with zeros
__device__ __forceinline__ void cp_async16z(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4z(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// 3xTF32.  hi = tf32(v) rounds v to 10 mantissa bits, to nearest with ties
// away from zero (cvt.rna.tf32.f32's rounding; an add and a mask), lo = v - hi
// (exact in float32), which the tensor core reads at tf32 precision, its low
// 13 bits dropped, as CUTLASS's 3xTF32 passes its small part.  A product sums
// lo hi' + hi lo' + hi hi'; lo lo' (~2^-22 of it) is dropped: float32
// accuracy on the tensor cores, three instructions a split operand.
struct Frag {
  uint32_t hi, lo;
};
__device__ __forceinline__ Frag split(float v) {
  const uint32_t h = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  return {h, __float_as_uint(v - __uint_as_float(h))};
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
// One m16n8k8 step of a float32 product.  A fragment: lane (g, tg) = (lane / 4,
// lane % 4) holds rows g, g + 8 at k = kA, kA + 4 (a[0..3]: (g, kA), (g+8, kA),
// (g, kA+4), (g+8, kA+4)); B: k = kA, kA + 4 at column g.  The accumulator
// d[0..3] is (g, 2 tg), (g, 2 tg + 1), (g + 8, 2 tg), (g + 8, 2 tg + 1).  The
// k order inside a step is free as long as A and B agree: "std" operands take
// kA = tg, "perm" operands kA = 2 tg (kA + 4 -> 2 tg + 1), so a float2 holds
// both of a row's values.
__device__ __forceinline__ void mma3(float (&d)[4], const Frag (&a)[4], const Frag (&b)[2]) {
  mma_tf32(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}
// the same with the lo terms in an accumulator of their own (d + dl is the
// product): chains of two and one MMA a step instead of three
__device__ __forceinline__ void mma3x(float (&d)[4], float (&dl)[4], const Frag (&a)[4],
                                      const Frag (&b)[2]) {
  mma_tf32(dl, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  mma_tf32(dl, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

// std A from a padded row-major tile (rows r0.., columns k0..), rows scaled
__device__ __forceinline__ void frag_a_std(Frag (&a)[4], const float* t, int ld, int r0,
                                           int k0, float s_lo = 1.0f, float s_hi = 1.0f) {
  const int lane = threadIdx.x & 31;
  const float* p = t + (r0 + (lane >> 2)) * ld + k0 + (lane & 3);
  a[0] = split(p[0] * s_lo);
  a[1] = split(p[8 * ld] * s_hi);
  a[2] = split(p[4] * s_lo);
  a[3] = split(p[8 * ld + 4] * s_hi);
}
// std B from a padded tile stored (n, k): b = T[n0 + g][k0 + tg, + 4]
__device__ __forceinline__ void frag_b_std_nk(Frag (&b)[2], const float* t, int ld, int n0,
                                              int k0) {
  const int lane = threadIdx.x & 31;
  const float* p = t + (n0 + (lane >> 2)) * ld + k0 + (lane & 3);
  b[0] = split(p[0]);
  b[1] = split(p[4]);
}
// std B from a swizzled tile stored (k, n): b = T[k0 + tg, + 4][n0 + g]
__device__ __forceinline__ void frag_b_std_kn_swz(Frag (&b)[2], const float* t, int ld, int k0,
                                                  int n0) {
  const int lane = threadIdx.x & 31, k = k0 + (lane & 3), n = n0 + (lane >> 2);
  b[0] = split(t[swz(k, n, ld)]);
  b[1] = split(t[swz(k + 4, n, ld)]);
}
// perm A from a swizzled row-major tile: float2s at (r0 + g, k0 + 2 tg)
__device__ __forceinline__ void frag_a_perm(Frag (&a)[4], const float* t, int ld, int r0,
                                            int k0) {
  const int lane = threadIdx.x & 31, r = r0 + (lane >> 2), k = k0 + 2 * (lane & 3);
  const float2 u = *reinterpret_cast<const float2*>(t + swz(r, k, ld));
  const float2 v = *reinterpret_cast<const float2*>(t + swz(r + 8, k, ld));
  a[0] = split(u.x);
  a[2] = split(u.y);
  a[1] = split(v.x);
  a[3] = split(v.y);
}
// perm B from a padded tile stored (k, n): b = T[k0 + 2 tg, + 1][n0 + g]
__device__ __forceinline__ void frag_b_perm_kn(Frag (&b)[2], const float* t, int ld, int k0,
                                               int n0) {
  const int lane = threadIdx.x & 31;
  const float* p = t + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
  b[0] = split(p[0]);
  b[1] = split(p[ld]);
}
// perm B from a swizzled tile stored (n, k): a float2 at (n0 + g, k0 + 2 tg)
__device__ __forceinline__ void frag_b_perm_nk_swz(Frag (&b)[2], const float* t, int ld,
                                                   int n0, int k0) {
  const int lane = threadIdx.x & 31;
  const float2 u = *reinterpret_cast<const float2*>(
      t + swz(n0 + (lane >> 2), k0 + 2 * (lane & 3), ld));
  b[0] = split(u.x);
  b[1] = split(u.y);
}

// (strip i, block j) of tile k of the triangle: rows t in [16 i, 16 i + 16),
// columns s in [8 j, 8 j + 8), j >= 2 i (the tiles that hold some s >= t)
__device__ __forceinline__ void tile_ij(int k, int& i, int& j) {
  if (k < 8) {
    i = 0, j = k;
  } else if (k < 14) {
    i = 1, j = k - 6;
  } else if (k < 18) {
    i = 2, j = k - 10;
  } else {
    i = 3, j = k - 12;
  }
}

// rows x 64 floats (row-major, rows of `cols`) into a tile of kLd-float rows,
// rows_alloc rows, zero past rows and cols: 16-byte copies where vec, else 4
__device__ __forceinline__ void copy_rows(float* dst, const float* __restrict__ src, int rows,
                                          int cols, int rows_alloc, int vec) {
  const int per_row = vec ? kMaxP / 4 : kMaxP;
  for (int i = threadIdx.x; i < rows_alloc * per_row; i += kThreads) {
    const int r = i / per_row, cc = (i % per_row) * (vec ? 4 : 1);
    const bool ok = r < rows && cc < cols;
    const float* from = ok ? src + (size_t)r * cols + cc : src;
    if (vec)
      cp_async16z(dst + r * kLd + cc, from, ok ? 16 : 0);
    else
      cp_async4z(dst + r * kLd + cc, from, ok ? 4 : 0);
  }
}
// Q x N of B or C into a swizzled (kGQ, kMaxN) tile, zero past Q and N
__device__ __forceinline__ void copy_bc(float* dst, const float* __restrict__ src, int Q, int N,
                                        int vec) {
  if (vec) {
    for (int i = threadIdx.x; i < kGQ * (kMaxN / 4); i += kThreads) {
      const int r = i / (kMaxN / 4), c4 = (i % (kMaxN / 4)) * 4;
      const bool ok = r < Q && c4 < N;
      cp_async16z(dst + swz(r, c4, kMaxN), ok ? src + (size_t)r * N + c4 : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kGQ * kMaxN; i += kThreads) {
      const int r = i / kMaxN, cc = i % kMaxN;
      const bool ok = r < Q && cc < N;
      cp_async4z(dst + swz(r, cc, kMaxN), ok ? src + (size_t)r * N + cc : src, ok ? 4 : 0);
    }
  }
}

// 2'. The backward's two state walks in one launch: blocks [0, n_state) walk
// forward (x, B and the weights w give S_in), the rest in reverse (dy, C and
// exp(L) give G, the gradient of the state leaving each chunk:
// G_{c-1} = exp(L_Q) G_c + sum_s exp(L_s) C_s dy_s^T, G_{nc-1} = 0).  One CTA
// per (b, h, kWalkRows rows of N), 8 warps, each a 16 x 32 block of the
// state in registers.  A chunk's update (B w)^T x is a 64 x 64 x Q product on
// 3xTF32 MMAs; the next chunk's B, x and w are copied in (cp.async) while it
// runs, so only the carry S <- exp(L_Q) S + update is in order.  74 KB of
// shared memory and at most 80 registers a thread: at mamba2-130m's training
// shape all 384 CTAs of both walks are resident at once, three an SM.
__global__ void __launch_bounds__(kThreads, 3)
ssd_walks_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                 const float* __restrict__ w, const float* __restrict__ dy,
                 const float* __restrict__ cm, const float* __restrict__ ez,
                 const float* __restrict__ decay, float* __restrict__ s_in,
                 float* __restrict__ g_st, int H, int S, int P, int N, int Q, int nc,
                 int n_tiles, int n_state, int vec) {
  extern __shared__ __align__(16) float smem[];
  const bool rev = (int)blockIdx.x >= n_state;
  const int block = rev ? (int)blockIdx.x - n_state : (int)blockIdx.x;
  const float* __restrict__ xs = rev ? dy : x;
  const float* __restrict__ bs = rev ? cm : bm;
  const float* __restrict__ ws = rev ? ez : w;
  float* __restrict__ out = rev ? g_st : s_in;
  const int nt = block % n_tiles;
  const long long bh = block / n_tiles;
  const int bi = (int)(bh / H), n0 = nt * kWalkRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = 16 * (warp & 3), p0 = 32 * (warp >> 2);  // this warp's block
  const float* x_bh = xs + (size_t)bh * S * P;
  const float* w_bh = ws + (size_t)bh * S;
  const float* b_b = bs + (size_t)bi * S * N;

  // stage: B[t][n0 .. n0 + 64) and x[t][0 .. 64) in rows of kWalkLd floats,
  // then w; rows past Q, columns past N or P zero
  auto load = [&](int c, int buf) {
    float* sB = smem + buf * kWalkStage;
    float* sX = sB + kGQ * kWalkLd;
    float* sW = sX + kGQ * kWalkLd;
    const size_t t0 = (size_t)c * Q;
    if (vec) {
      for (int i = tid; i < kGQ * (kWalkRows / 4); i += kThreads) {
        const int t = i / (kWalkRows / 4), c4 = (i % (kWalkRows / 4)) * 4;
        const bool okb = t < Q && n0 + c4 < N, okx = t < Q && c4 < P;
        cp_async16z(sB + t * kWalkLd + c4, okb ? b_b + (t0 + t) * N + n0 + c4 : b_b,
                    okb ? 16 : 0);
        cp_async16z(sX + t * kWalkLd + c4, okx ? x_bh + (t0 + t) * P + c4 : x_bh, okx ? 16 : 0);
      }
      if (tid < kGQ / 4) {
        const bool ok = tid * 4 < Q;
        cp_async16z(sW + tid * 4, ok ? w_bh + t0 + tid * 4 : w_bh, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kGQ * kWalkRows; i += kThreads) {
        const int t = i / kWalkRows, cc = i % kWalkRows;
        const bool okb = t < Q && n0 + cc < N, okx = t < Q && cc < P;
        cp_async4z(sB + t * kWalkLd + cc, okb ? b_b + (t0 + t) * N + n0 + cc : b_b, okb ? 4 : 0);
        cp_async4z(sX + t * kWalkLd + cc, okx ? x_bh + (t0 + t) * P + cc : x_bh, okx ? 4 : 0);
      }
      if (tid < kGQ) cp_async4z(sW + tid, tid < Q ? w_bh + t0 + tid : w_bh, tid < Q ? 4 : 0);
    }
  };

  float st[4][4];  // rows n0 + r0 + g (+ 8), columns p0 + 8 j + 2 tg (+ 1)
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[j][e] = 0.0f;
  load(rev ? nc - 1 : 0, 0);
  cp_async_commit();
  for (int k = 0; k < nc; ++k) {
    const int c = rev ? nc - 1 - k : k;
    if (k + 1 < nc) load(rev ? c - 1 : c + 1, (k + 1) & 1);
    cp_async_commit();
    const float dq = decay[bh * nc + c];
    cp_async_wait<1>();
    __syncthreads();
    float* o = out + ((size_t)bh * nc + c) * N * P;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = n0 + r0 + g + 8 * r, p = p0 + 8 * j + 2 * tg;
        if (n >= N || p >= P) continue;
        float* d = o + (size_t)n * P + p;
        if (vec) {  // P % 4 == 0: p + 1 < P too
          *reinterpret_cast<float2*>(d) = make_float2(st[j][2 * r], st[j][2 * r + 1]);
        } else {
          d[0] = st[j][2 * r];
          if (p + 1 < P) d[1] = st[j][2 * r + 1];
        }
      }
    }
    const float* sB = smem + (k & 1) * kWalkStage;
    const float* sX = sB + kGQ * kWalkLd;
    const float* sW = sX + kGQ * kWalkLd;
#pragma unroll
    for (int j = 0; j < 4; ++j)  // the carry, then the chunk's update on top
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] *= dq;
#pragma unroll 1
    for (int k0 = 0; k0 < kGQ; k0 += 8) {
      // A = (B w)^T: rows n, k = t; B = x: k = t, columns p
      const float w0 = sW[k0 + tg], w1 = sW[k0 + tg + 4];
      const float* b0 = sB + (k0 + tg) * kWalkLd + r0 + g;
      Frag af[4];
      af[0] = split(b0[0] * w0);
      af[1] = split(b0[8] * w0);
      af[2] = split(b0[4 * kWalkLd] * w1);
      af[3] = split(b0[4 * kWalkLd + 8] * w1);
      const float* x0 = sX + (k0 + tg) * kWalkLd + p0 + g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Frag bf[2];
        bf[0] = split(x0[8 * j]);
        bf[1] = split(x0[4 * kWalkLd + 8 * j]);
        mma3(st[j], af, bf);
      }
    }
    __syncthreads();  // stage k & 1 is refilled by the next iteration's load
  }
}

// 3. The gradients of one (b, chunk) over every head, Q <= 64.  With L the
// chunk's cumsum of dt * a, D_st = dy_s . x_t, dec_st = exp(L_s - L_t) (t <= s,
// else the mask -1e30 before the exp, as the plain version), A = (C B^T) dec,
// W_st = dec_st dt_t D_st and M = (C B^T) W:
//   g_t  = sum_s A_st dy_s + exp(L_Q - L_t) G^T B_t,   dx_t = dt_t g_t
//   db_t = sum_s W_st C_s + exp(L_Q - L_t) dt_t G x_t
//   dc_s = sum_t W_st B_t + exp(L_s) S_in dy_s
//   dL_s = sum_t M_st - sum_s' M_s's + exp(L_s) C_s . (S_in dy_s) - R_s,
//          R_t = exp(L_Q - L_t) dt_t (G^T B_t) . x_t,
//   dL at the chunk's last step also + sum_t R_t + exp(L_Q) <S_in, G>
//   ddt_t = x_t . g_t + a sum_{u >= t} dL_u,  da += sum_t dt_t sum_{u >= t} dL_u.
// B and C are one group, so the head sums of db's and dc's first terms are
// (sum_h W_h)^T C and (sum_h W_h) B: products taken once after the heads.
// Per head, on 3xTF32 MMAs (8 warps): D^T = x dy^T on the 20 tiles of its
// triangle (warp w: tiles w, w + 8, w + 16), whence A^T (to shared memory),
// W (summed over the heads in registers) and M's row and column sums; g's
// two products A^T dy and B G (warp w: t strips {0, 3} or {1, 2}, 16 columns
// of P); V = dy S_in^T (for dc and dL) and db += diag(exp(L_Q - L) dt) x G^T
// (warp w: 32 rows, 32 columns of N).  x/dy, G and S_in of the next heads are
// copied (cp.async, zero-filled) into a ring of four slots while the current
// head computes: a slot is refilled as soon as its last reader is done.
__global__ void __launch_bounds__(kThreads, 1)
ssd_grad_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const float* __restrict__ bm,
                const float* __restrict__ cm, const float* __restrict__ dy,
                const float* __restrict__ lcum, const float* __restrict__ s_in,
                const float* __restrict__ g_st, float* __restrict__ dx,
                float* __restrict__ ddt, float* __restrict__ db, float* __restrict__ dc,
                float* __restrict__ da_part, int H, int S, int P, int N, int Q, int nc,
                int vec) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem + GradLayout::ring;
  float* sB = smem + GradLayout::b;
  float* sC = smem + GradLayout::c;
  float* sAt = smem + GradLayout::at;
  float* rowp = smem + GradLayout::rowp;
  float* colp = smem + GradLayout::colp;
  float* xgp = smem + GradLayout::xgp;
  float* rp = smem + GradLayout::rp;
  float* ip = smem + GradLayout::ip;
  float* red = smem + GradLayout::red;
  float* last = smem + GradLayout::last;

  const int c = blockIdx.x % nc, bi = blockIdx.x / nc;
  const size_t t0 = (size_t)c * Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;

  // a head's vectors (index h mod 3): L, dt, exp(L), exp(L_Q - L), dL without
  // the last step's extra terms, and x . g
  auto vecs = [&](int h) { return smem + GradLayout::vec + (h % 3) * 6 * kGQ; };
  // a head's copies: x and dy into a slot with L and dt into its vectors, or
  // S_in / G into a slot
  auto load_xdy = [&](int h, int slot) {
    const size_t row0 = ((size_t)bi * H + h) * S + t0;
    float* dst = ring + slot * kSlot;
    copy_rows(dst, x + row0 * P, Q, P, kGQ, vec);
    copy_rows(dst + kGQ * kLd, dy + row0 * P, Q, P, kGQ, vec);
    float* v = vecs(h);
    if (tid < kGQ)
      cp_async4z(v + tid, lcum + row0 + (tid < Q ? tid : 0), tid < Q ? 4 : 0);
    else if (tid < 2 * kGQ)
      cp_async4z(v + tid, dt + row0 + (tid - kGQ < Q ? tid - kGQ : 0), tid - kGQ < Q ? 4 : 0);
  };
  auto load_state = [&](const float* src, int h, int slot) {
    copy_rows(ring + slot * kSlot, src + (((size_t)bi * H + h) * nc + c) * N * P, N, P,
              kMaxN, vec);
  };
  auto exps = [&](int h) {  // exp(L) and exp(L_Q - L), by the first 64 threads
    float* v = vecs(h);
    if (tid < kGQ) {
      v[2 * kGQ + tid] = tid < Q ? expf(v[tid]) : 0.0f;
      v[3 * kGQ + tid] = tid < Q ? expf(v[Q - 1] - v[tid]) : 0.0f;
    }
  };
  // Slots of the current head's x/dy, G and S_in and of the next head's x/dy;
  // a slot is refilled as soon as its last reader is done.  cp.async groups
  // are committed in the order the heads wait for them: at the top of head h,
  // G_h, S_h and x/dy_{h+1} are in flight.
  int sx = 0, sg = 1, ss = 2, sn = 3;
  copy_bc(sB, bm + ((size_t)bi * S + t0) * N, Q, N, vec);
  copy_bc(sC, cm + ((size_t)bi * S + t0) * N, Q, N, vec);
  load_xdy(0, sx);
  cp_async_commit();
  load_state(g_st, 0, sg);
  cp_async_commit();
  load_state(s_in, 0, ss);
  cp_async_commit();
  if (H > 1) load_xdy(1, sn);
  cp_async_commit();
  cp_async_wait<3>();  // B, C, x/dy_0
  __syncthreads();
  exps(0);

  // this warp's triangle tiles: w, w + 8, w + 16 (< kTiles)
  int ti[3], tj[3];
#pragma unroll
  for (int m = 0; m < 3; ++m) tile_ij(min(warp + 8 * m, kTiles - 1), ti[m], tj[m]);
  // C B^T on them, kept in registers as (t, s): B_t . C_s
  float cbt[3][4], wsum[3][4];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) cbt[m][e] = wsum[m][e] = 0.0f;
    if (warp + 8 * m >= kTiles) continue;
#pragma unroll 4
    for (int k0 = 0; k0 < kMaxN; k0 += 8) {
      Frag af[4], bf[2];
      frag_a_perm(af, sB, kMaxN, 16 * ti[m], k0);
      frag_b_perm_nk_swz(bf, sC, kMaxN, 8 * tj[m], k0);
      mma3(cbt[m], af, bf);
    }
  }

  float db_acc[2][4][4], dc_acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) db_acc[i][j][e] = dc_acc[i][j][e] = 0.0f;
  const int rbase = (warp & 1) * 32, nbase = (warp >> 1) * 32;  // V, db, dc tiles
  const int quarter = warp >> 1;                                // g's 16 columns
  const int strip_a = warp & 1, strip_b = 3 - strip_a;          // g's t strips

  for (int h = 0; h < H; ++h) {
    const long long bh = (long long)bi * H + h;
    const size_t row0 = (size_t)bh * S + t0;
    float* sX = ring + sx * kSlot;
    float* sDY = sX + kGQ * kLd;
    float* sG = ring + sg * kSlot;
    float* sS = ring + ss * kSlot;
    float* sL = vecs(h);
    float* sDt = sL + kGQ;
    float* sE = sDt + kGQ;
    float* sEt = sE + kGQ;
    float* sDL = sEt + kGQ;
    float* sXG = sDL + kGQ;

    {  // 1. D^T = x dy^T on the triangle: A^T, W into the head sum, M's sums.
       // The warp's tiles in one loop and the hi.hi and the lo terms in two
       // accumulators: six independent MMA chains.
      float acc[3][4], accx[3][4];
#pragma unroll
      for (int m = 0; m < 3; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][e] = accx[m][e] = 0.0f;
#pragma unroll
      for (int k0 = 0; k0 < kMaxP; k0 += 8) {
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          if (warp + 8 * m >= kTiles) continue;
          Frag af[4], bf[2];
          frag_a_std(af, sX, kLd, 16 * ti[m], k0);
          frag_b_std_nk(bf, sDY, kLd, 8 * tj[m], k0);
          mma3x(acc[m], accx[m], af, bf);
        }
      }
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        if (warp + 8 * m >= kTiles) continue;
        float at[4], rsum[2] = {0.f, 0.f}, csum[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 16 * ti[m] + g + 8 * (e >> 1), s = 8 * tj[m] + 2 * tg + (e & 1);
          const bool ok = s < Q && t <= s;
          const float dec = expf(ok ? sL[s] - sL[t] : -1e30f);  // a select, not a branch
          const float w = dec * sDt[t] * (acc[m][e] + accx[m][e]);
          const float mv = cbt[m][e] * w;
          wsum[m][e] += w;
          at[e] = cbt[m][e] * dec;
          rsum[e >> 1] += mv;
          csum[e & 1] += mv;
        }
        const int t = 16 * ti[m] + g, s = 8 * tj[m] + 2 * tg;
        *reinterpret_cast<float2*>(sAt + swz(t, s, kGQ)) = make_float2(at[0], at[1]);
        *reinterpret_cast<float2*>(sAt + swz(t + 8, s, kGQ)) = make_float2(at[2], at[3]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // rows t over this tile's 8 columns
          float v = rsum[r];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (tg == 0) rowp[tj[m] * kGQ + t + 8 * r] = v;
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {  // columns s over this tile's 16 rows
          float v = csum[q];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) colp[ti[m] * kGQ + s + q] = v;
        }
      }
    }
    cp_async_wait<2>();  // G_h
    __syncthreads();

    {  // 2. g = A^T dy + exp(L_Q - L) B G; dx, x . g and x . (B G).  A^T dy's
       // eight steps (s >= t: strip i takes blocks kb >= 2 i) ride in B G's
       // sixteen, whose lo terms have their own accumulators.
      float gi[2][2][4], bg[2][2][4], bgx[2][2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int v = 0; v < 2; ++v)
#pragma unroll
          for (int e = 0; e < 4; ++e) gi[u][v][e] = bg[u][v][e] = bgx[u][v][e] = 0.0f;
#pragma unroll
      for (int kb = 0; kb < kMaxN / 8; ++kb) {
        {
          Frag bf[2][2];
#pragma unroll
          for (int v = 0; v < 2; ++v)
            frag_b_perm_kn(bf[v], sG, kLd, 8 * kb, 16 * quarter + 8 * v);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            Frag af[4];
            frag_a_perm(af, sB, kMaxN, 16 * (u ? strip_b : strip_a), 8 * kb);
#pragma unroll
            for (int v = 0; v < 2; ++v) mma3x(bg[u][v], bgx[u][v], af, bf[v]);
          }
        }
        if (kb < kGQ / 8) {
          Frag bf[2][2];
#pragma unroll
          for (int v = 0; v < 2; ++v)
            frag_b_perm_kn(bf[v], sDY, kLd, 8 * kb, 16 * quarter + 8 * v);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int strip = u ? strip_b : strip_a;
            if (kb < 2 * strip) continue;
            Frag af[4];
            frag_a_perm(af, sAt, kGQ, 16 * strip, 8 * kb);
#pragma unroll
            for (int v = 0; v < 2; ++v) mma3(gi[u][v], af, bf[v]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int strip = u ? strip_b : strip_a;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = 16 * strip + g + 8 * r;
          const float et = sEt[t], dtt = sDt[t];
          float xg = 0.0f, xr = 0.0f;
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int p = 16 * quarter + 8 * v + 2 * tg;
            const float2 xv = *reinterpret_cast<const float2*>(sX + t * kLd + p);
            const float b0 = bg[u][v][2 * r] + bgx[u][v][2 * r];
            const float b1 = bg[u][v][2 * r + 1] + bgx[u][v][2 * r + 1];
            const float g0 = fmaf(et, b0, gi[u][v][2 * r]);
            const float g1 = fmaf(et, b1, gi[u][v][2 * r + 1]);
            xg = fmaf(xv.x, g0, fmaf(xv.y, g1, xg));
            xr = fmaf(xv.x, b0, fmaf(xv.y, b1, xr));
            if (t < Q && p < P) {
              float* out = dx + (row0 + t) * P + p;
              if (vec) {  // P % 4 == 0: p + 1 < P too
                *reinterpret_cast<float2*>(out) = make_float2(dtt * g0, dtt * g1);
              } else {
                out[0] = dtt * g0;
                if (p + 1 < P) out[1] = dtt * g1;
              }
            }
          }
          xg += __shfl_xor_sync(0xffffffffu, xg, 1);
          xg += __shfl_xor_sync(0xffffffffu, xg, 2);
          xr += __shfl_xor_sync(0xffffffffu, xr, 1);
          xr += __shfl_xor_sync(0xffffffffu, xr, 2);
          if (tg == 0) {
            xgp[quarter * kGQ + t] = xg;
            rp[quarter * kGQ + t] = xr;
          }
        }
      }
    }
    cp_async_wait<1>();  // S_h
    __syncthreads();

    {  // 3. V = dy S_in^T: dc += diag(exp(L)) V, C . V for dL; <S_in, G>
      float vacc[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) vacc[i][j][e] = 0.0f;
#pragma unroll
      for (int k0 = 0; k0 < kMaxP; k0 += 8) {
        Frag af[2][4], bf[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) frag_a_std(af[i], sDY, kLd, rbase + 16 * i, k0);
#pragma unroll
        for (int j = 0; j < 4; ++j) frag_b_std_nk(bf[j], sS, kLd, nbase + 8 * j, k0);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma3(vacc[i][j], af[i], bf[j]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int s = rbase + 16 * i + g + 8 * r;
          const float es = sE[s];
          float iv = 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 cv =
                *reinterpret_cast<const float2*>(sC + swz(s, nbase + 8 * j + 2 * tg, kMaxN));
            const float v0 = vacc[i][j][2 * r], v1 = vacc[i][j][2 * r + 1];
            iv = fmaf(cv.x, v0, fmaf(cv.y, v1, iv));
            dc_acc[i][j][2 * r] = fmaf(es, v0, dc_acc[i][j][2 * r]);
            dc_acc[i][j][2 * r + 1] = fmaf(es, v1, dc_acc[i][j][2 * r + 1]);
          }
          iv += __shfl_xor_sync(0xffffffffu, iv, 1);
          iv += __shfl_xor_sync(0xffffffffu, iv, 2);
          if (tg == 0) ip[quarter * kGQ + s] = iv;
        }
      }
      float v = 0.0f;  // both tiles zero past N and P
      for (int i = tid; i < kMaxN * (kMaxP / 4); i += kThreads) {
        const int n = i / (kMaxP / 4), p = (i % (kMaxP / 4)) * 4;
        const float4 sv = *reinterpret_cast<const float4*>(sS + n * kLd + p);
        const float4 gv = *reinterpret_cast<const float4*>(sG + n * kLd + p);
        v = fmaf(sv.w, gv.w, fmaf(sv.z, gv.z, fmaf(sv.y, gv.y, fmaf(sv.x, gv.x, v))));
      }
      v = warp_sum(v);
      if (lane == 0) red[warp] = v;
    }
    __syncthreads();  // S_in is read: its slot takes the next head's G
    if (h + 1 < H) load_state(g_st, h + 1, ss);
    cp_async_commit();

    if (tid < kGQ) {  // dL_u without the last step's extra terms, and x . g
      const int u = tid, strip = u >> 4;
      float colsum = 0.0f, rowsum = 0.0f, inter = 0.0f, rsum = 0.0f, xgs = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i <= strip) colsum += colp[i * kGQ + u];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j >= 2 * strip) rowsum += rowp[j * kGQ + u];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        inter += ip[q * kGQ + u];
        rsum += rp[q * kGQ + u];
        xgs += xgp[q * kGQ + u];
      }
      const float r = sEt[u] * sDt[u] * rsum;  // R_u
      sDL[u] = colsum - rowsum + sE[u] * inter - r;
      sXG[u] = xgs;
      const float r_sum = warp_sum(r);  // the last step's extra: sum_t R_t
      if (lane == 0) last[warp] = r_sum;
      if (tid == 0) {  // and exp(L_Q) <S_in, G>
        float ssg = 0.0f;
#pragma unroll
        for (int k = 0; k < kThreads / 32; ++k) ssg += red[k];
        last[2] = sE[Q - 1] * ssg;
      }
    }

    // 4. db += diag(exp(L_Q - L) dt) x G^T
#pragma unroll
    for (int k0 = 0; k0 < kMaxP; k0 += 8) {
      Frag af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = rbase + 16 * i + g;
        frag_a_std(af[i], sX, kLd, rbase + 16 * i, k0, sEt[t] * sDt[t],
                   sEt[t + 8] * sDt[t + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) frag_b_std_nk(bf[j], sG, kLd, nbase + 8 * j, k0);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma3(db_acc[i][j], af[i], bf[j]);
    }
    cp_async_wait<1>();  // x/dy, L and dt of the next head
    __syncthreads();  // x, dy and G are read: their slots take the next copies
    if (h + 1 < H) load_state(s_in, h + 1, sx);
    cp_async_commit();
    if (h + 2 < H) load_xdy(h + 2, sg);
    cp_async_commit();
    if (h + 1 < H) exps(h + 1);

    // 5. dL's suffix sums over the chunk, ddt and da's share, by the last
    // warp (two triangle tiles), while the others start the next head
    if (warp == kThreads / 32 - 1) {
      const float extra = last[0] + last[1] + last[2];
      float dl[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int u = lane * 2 + k;
        dl[k] = u < Q ? sDL[u] + (u == Q - 1 ? extra : 0.0f) : 0.0f;
      }
      const float own = dl[0] + dl[1];
      float incl = own;  // sum over lanes >= lane
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += o;
      }
      const float rc1 = incl - own + dl[1];  // sum_{u >= 2 lane + 1} dL_u
      const float rc0 = rc1 + dl[0];
      const float ah = a[h];
      float share = 0.0f;
      if (lane * 2 < Q) {
        ddt[row0 + lane * 2] = fmaf(ah, rc0, sXG[lane * 2]);
        share = sDt[lane * 2] * rc0;
      }
      if (lane * 2 + 1 < Q) {
        ddt[row0 + lane * 2 + 1] = fmaf(ah, rc1, sXG[lane * 2 + 1]);
        share = fmaf(sDt[lane * 2 + 1], rc1, share);
      }
      share = warp_sum(share);
      if (lane == 0) da_part[bh * nc + c] = share;
    }
    const int nx = sn, ng = ss, ns = sx, nn = sg;
    sx = nx, sg = ng, ss = ns, sn = nn;
  }

  // 6. The head sums: db += W^T C and dc += W B, W = sum_h W_h, from two
  // tiles of the free ring (W^T rows t, W rows s; entries past the triangle's
  // tiles are never read)
  cp_async_wait<0>();
  __syncthreads();
  float* sWt = ring;
  float* sW = ring + kSlot;
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const int k = warp + 8 * m;
    if (k >= kTiles) break;
    int ti, tj;
    tile_ij(k, ti, tj);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = 16 * ti + g + 8 * (e >> 1), s = 8 * tj + 2 * tg + (e & 1);
      sWt[t * kLd + s] = wsum[m][e];
      sW[s * kLd + t] = wsum[m][e];
    }
  }
  __syncthreads();
#pragma unroll
  for (int kb = 0; kb < 8; ++kb) {
    Frag bc[4][2], bb[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      frag_b_std_kn_swz(bc[j], sC, kMaxN, 8 * kb, nbase + 8 * j);
      frag_b_std_kn_swz(bb[j], sB, kMaxN, 8 * kb, nbase + 8 * j);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int strip = (rbase >> 4) + i;
      if (kb >= 2 * strip) {  // db_t: s >= t
        Frag af[4];
        frag_a_std(af, sWt, kLd, 16 * strip, 8 * kb);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma3(db_acc[i][j], af, bc[j]);
      }
      if (kb <= 2 * strip + 1) {  // dc_s: t <= s
        Frag af[4];
        frag_a_std(af, sW, kLd, 16 * strip, 8 * kb);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma3(dc_acc[i][j], af, bb[j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = rbase + 16 * i + g + 8 * r;
      if (t >= Q) continue;
      const size_t row = ((size_t)bi * S + t0 + t) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = nbase + 8 * j + 2 * tg;
        const float b0 = db_acc[i][j][2 * r], b1 = db_acc[i][j][2 * r + 1];
        const float c0 = dc_acc[i][j][2 * r], c1 = dc_acc[i][j][2 * r + 1];
        if (n >= N) continue;
        if (vec) {  // N % 4 == 0: n + 1 < N too
          *reinterpret_cast<float2*>(db + row + n) = make_float2(b0, b1);
          *reinterpret_cast<float2*>(dc + row + n) = make_float2(c0, c1);
        } else {
          db[row + n] = b0, dc[row + n] = c0;
          if (n + 1 < N) db[row + n + 1] = b1, dc[row + n + 1] = c1;
        }
      }
    }
  }
}

// 4. da_h = the sum of the (b, chunk) shares, one warp a head, in a fixed order
__global__ void ssd_da_kernel(const float* __restrict__ part, float* __restrict__ da,
                              int B, int H, int nc) {
  const int h = blockIdx.x, lane = threadIdx.x;
  float v = 0.0f;
  for (int b = 0; b < B; ++b)
    for (int c = lane; c < nc; c += 32) v += part[((size_t)b * H + h) * nc + c];
  v = warp_sum(v);
  if (lane == 0) da[h] = v;
}

cudaError_t opt_in(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" {

const char* ssd_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// s_in: scratch of B * H * (S / Q) * N * P floats; scan: of B * H * (2 S + S / Q)
int ssd_chunk(const void* x, const void* dt, const void* a, const void* b, const void* c,
              void* y, void* s_in, void* scan, int B, int H, int S, int P, int N, int Q,
              void* stream) {
  if (B < 0 || H < 0 || S < 0 || P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 ||
      Q > kMaxQ || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H == 0 || S == 0) return 0;
  const int nc = S / Q;
  const int n_tiles = (N + kNT - 1) / kNT;
  const int n_groups = (H + kHeads - 1) / kHeads;
  const long long n_warps = (long long)B * H * nc;
  const long long n_scan = (n_warps + kThreads / 32 - 1) / (kThreads / 32);
  const long long n_state = (long long)B * H * n_tiles;
  const long long n_out = (long long)B * nc * n_groups;
  if (n_scan > 2147483647LL || n_state > 2147483647LL || n_out > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem_state = sizeof(float) * 2 * state_stage_floats(Q, P);
  const size_t smem_out = sizeof(float) * OutLayout(Q, N, P).total;
  if (smem_state > (size_t)kSmemMax || smem_out > (size_t)kSmemMax)
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = opt_in((const void*)ssd_state_kernel, smem_state);
  if (err == cudaSuccess) err = opt_in((const void*)ssd_out_kernel, smem_out);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* bf = static_cast<const float*>(b);
  float* sf = static_cast<float*>(s_in);
  float* lcum = static_cast<float*>(scan);
  float* w = lcum + (size_t)B * H * S;
  float* decay = w + (size_t)B * H * S;
  // float4 copies need rows of whole float4s and 16-byte aligned tensors
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(s_in) | reinterpret_cast<uintptr_t>(w);
  const int vec = N % 4 == 0 && P % 4 == 0 && Q % 4 == 0 && ptrs % 16 == 0;

  ssd_scan_kernel<<<dim3((unsigned)n_scan), kThreads, 0, st>>>(
      dtf, static_cast<const float*>(a), lcum, w, decay, nullptr, H, S, Q, nc, n_warps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_state_kernel<<<dim3((unsigned)n_state), kStateThreads, smem_state, st>>>(
      xf, bf, w, decay, sf, H, S, P, N, Q, nc, n_tiles, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_out_kernel<<<dim3((unsigned)n_out), kThreads, smem_out, st>>>(
      xf, dtf, bf, static_cast<const float*>(c), lcum, sf, static_cast<float*>(y), H, S, P,
      N, Q, nc, n_groups, vec);
  return (int)cudaGetLastError();
}

// The gradients of ssd_chunk for the output gradient dy: dx (B, H, S, P),
// ddt (B, H, S), da (H), db and dc (B, S, N), at chunks of Q <= 64 steps.
// The entry recomputes the forward's scan and states: scan is scratch of
// B * H * (3 S + S / Q) floats (L, w, exp(L), the decays), s_in and g_st of
// B * H * (S / Q) * N * P each (the states entering each chunk, and G, the
// gradient of the state leaving it), da_part of B * H * (S / Q).  Four
// launches in order on the stream: the scan, both state walks (one launch),
// the gradient kernel and da's reduction.
int ssd_chunk_bwd(const void* x, const void* dt, const void* a, const void* b, const void* c,
                  const void* dy, void* dx, void* ddt, void* da, void* db, void* dc,
                  void* s_in, void* g_st, void* scan, void* da_part, int B, int H, int S,
                  int P, int N, int Q, void* stream) {
  if (B < 0 || H < 0 || S < 0 || P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 ||
      Q > kGQ || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  const int nc = S / Q;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if ((long long)B * S > 0) {
    const int n_tiles = (N + kWalkRows - 1) / kWalkRows;
    const long long n_warps = (long long)B * H * nc;
    const long long n_scan = (n_warps + kThreads / 32 - 1) / (kThreads / 32);
    const long long n_state = (long long)B * H * n_tiles;
    const long long n_grad = (long long)B * nc;
    if (n_scan > 2147483647LL || 2 * n_state > 2147483647LL || n_grad > 2147483647LL)
      return (int)cudaErrorInvalidConfiguration;
    const size_t smem_walk = sizeof(float) * 2 * kWalkStage;
    const size_t smem_grad = sizeof(float) * GradLayout::total;
    if (smem_walk > (size_t)kSmemMax || smem_grad > (size_t)kSmemMax)
      return (int)cudaErrorInvalidConfiguration;
    err = opt_in((const void*)ssd_walks_kernel, smem_walk);
    if (err == cudaSuccess) err = opt_in((const void*)ssd_grad_kernel, smem_grad);
    if (err != cudaSuccess) return (int)err;
    const float* xf = static_cast<const float*>(x);
    const float* dtf = static_cast<const float*>(dt);
    const float* af = static_cast<const float*>(a);
    const float* bf = static_cast<const float*>(b);
    const float* cf = static_cast<const float*>(c);
    const float* dyf = static_cast<const float*>(dy);
    float* sf = static_cast<float*>(s_in);
    float* gf = static_cast<float*>(g_st);
    float* lcum = static_cast<float*>(scan);
    float* w = lcum + (size_t)B * H * S;
    float* ez = w + (size_t)B * H * S;
    float* decay = ez + (size_t)B * H * S;
    const uintptr_t ptrs =
        reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(b) |
        reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(dy) |
        reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(db) |
        reinterpret_cast<uintptr_t>(dc) | reinterpret_cast<uintptr_t>(s_in) |
        reinterpret_cast<uintptr_t>(g_st) | reinterpret_cast<uintptr_t>(w) |
        reinterpret_cast<uintptr_t>(ez);
    const int vec = N % 4 == 0 && P % 4 == 0 && Q % 4 == 0 && ptrs % 16 == 0;

    ssd_scan_kernel<<<dim3((unsigned)n_scan), kThreads, 0, st>>>(dtf, af, lcum, w, decay, ez,
                                                                 H, S, Q, nc, n_warps);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_walks_kernel<<<dim3((unsigned)(2 * n_state)), kThreads, smem_walk, st>>>(
        xf, bf, w, dyf, cf, ez, decay, sf, gf, H, S, P, N, Q, nc, n_tiles, (int)n_state, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_grad_kernel<<<dim3((unsigned)n_grad), kThreads, smem_grad, st>>>(
        xf, dtf, af, bf, cf, dyf, lcum, sf, gf, static_cast<float*>(dx),
        static_cast<float*>(ddt), static_cast<float*>(db), static_cast<float*>(dc),
        static_cast<float*>(da_part), H, S, P, N, Q, nc, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  ssd_da_kernel<<<dim3((unsigned)H), 32, 0, st>>>(static_cast<const float*>(da_part),
                                                   static_cast<float*>(da), B, H, nc);
  return (int)cudaGetLastError();
}

}  // extern "C"
