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
// the state leaving chunk c, it is written from the math, not from the
// forward's blocks (the formulas at ssd_grad_kernel): the scan and the state
// walk of the forward recompute L and S_in; the same walk in reverse
// (ssd_state_kernel<true>: C for B, dy for x, exp(L) for w) gives G; then one
// CTA per (b, chunk) forms C B^T once and, head by head, the masked Q x Q
// tiles A and W, the products for dx, db, dc and the decay gradient dL, whose
// suffix sums give ddt and a (b, h, chunk) share of da; a last kernel sums
// those shares per head.  db and dc sum over the heads in each CTA's
// registers in head order, da in a fixed order: no atomics, the same bits
// every run.  Operations bound it: at mamba2-130m's training shape
// (B=4, H=24, S=4096, Q=64, N=128, P=64) the gradient needs 42.5 GFLOP,
// ~2.9x the forward's (causal triangles only); the entry does more, whole
// Q x Q tiles and C S_in as a product of its own.  It works at
// chunks of at most 64 (kGQ): its shared memory is laid out for Q = 64,
// N = 128, P = 64 (222,272 B, one CTA an SM); the wrapper halves a longer
// chunk, which changes only the order of sums.  The products stay float32
// FMAs, as the forward's.

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

// 1. The state entering every chunk, in order over the chunks.  With kRev
// (the backward) the same walk in reverse: x -> dy, B -> C, w -> exp(L), and
// s_in -> G, the gradient of the state leaving each chunk
// (G_{c-1} = exp(L_Q) G_c + sum_s exp(L_s) C_s dy_s^T, G_{nc-1} = 0).
template <bool kRev>
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
  load(kRev ? nc - 1 : 0, 0);
  cp_async_commit();
  const bool active = n0 + ty * 4 < N && tx * 4 < P;
  for (int k = 0; k < nc; ++k) {
    const int c = kRev ? nc - 1 - k : k;
    if (k + 1 < nc) load(kRev ? c - 1 : c + 1, (k + 1) & 1);
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

constexpr int kGQ = 64;          // most rows of a chunk in the gradient kernel
constexpr int kLdQ = kGQ + 4;    // row stride of its Q x Q tiles

// the gradient kernel's shared memory, in floats: one fixed layout at the
// largest shapes (Q = 64, N = 128, P = 64), rows and columns past Q, N or P
// zero
struct GradLayout {
  static constexpr int c = 0;                        // C (kGQ, kMaxN) swizzled
  static constexpr int b = c + kGQ * kMaxN;          // B (kGQ, kMaxN) swizzled
  static constexpr int cb = b + kGQ * kMaxN;         // C B^T (kGQ, kLdQ)
  static constexpr int att = cb + kGQ * kLdQ;        // A (kGQ, kLdQ)
  static constexpr int wm = att + kGQ * kLdQ;        // W (kGQ, kLdQ)
  static constexpr int x = wm + kGQ * kLdQ;          // x (kGQ, kMaxP) swizzled
  static constexpr int dy = x + kGQ * kMaxP;         // dy (kGQ, kMaxP) swizzled
  static constexpr int s = dy + kGQ * kMaxP;         // S_in (kMaxN, kMaxP) swizzled
  static constexpr int g = s + kMaxN * kMaxP;        // G (kMaxN, kMaxP) swizzled
  static constexpr int vecs = g + kMaxN * kMaxP;     // 8 vectors of kGQ
  static constexpr int colpart = vecs + 8 * kGQ;     // (16, kGQ) column partials
  static constexpr int red = colpart + 16 * kGQ;     // 8 warps' partial sums
  static constexpr int total = red + kThreads / 32;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float dot4(float4 u, float4 v, float acc) {
  return fmaf(u.w, v.w, fmaf(u.z, v.z, fmaf(u.y, v.y, fmaf(u.x, v.x, acc))));
}
__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}
// sum over the 16 lanes of a half-warp (tx), the same order in every run
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows_alloc rows of a row-major (rows, cols) tile into a swizzled tile of
// row stride ld (a multiple of 32), zero past rows and cols
__device__ __forceinline__ void load_tile(float* dst, int ld, int rows_alloc,
                                          const float* __restrict__ src, int rows, int cols,
                                          int vec) {
  const int chunks = ld / 4;
  for (int i = threadIdx.x; i < rows_alloc * chunks; i += kThreads) {
    const int r = i / chunks, col = (i % chunks) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && col < cols) {
      const float* p = src + (size_t)r * cols + col;
      if (vec) {
        v = ld4(p);
      } else {
        v.x = p[0];
        if (col + 1 < cols) v.y = p[1];
        if (col + 2 < cols) v.z = p[2];
        if (col + 3 < cols) v.w = p[3];
      }
    }
    *reinterpret_cast<float4*>(dst + sw4(r, col, ld)) = v;
  }
}

// 3. The gradients of one (b, chunk) over every head, Q <= 64: dx, ddt's
// direct part and dL, then ddt and the chunk's share of da; db and dc summed
// over the heads in registers, in head order.  With L the chunk's cumsum of
// dt * a, D_st = dy_s . x_t, dec_st = exp(L_s - L_t) (t <= s, else the
// mask -1e30 before the exp, as the plain version), A = (C B^T) dec,
// W_st = dec_st dt_t D_st and M = (C B^T) W:
//   g_t  = sum_s A_st dy_s + exp(L_Q - L_t) G^T B_t,   dx_t = dt_t g_t
//   db_t = sum_s W_st C_s + exp(L_Q - L_t) dt_t G x_t
//   dc_s = sum_t W_st B_t + exp(L_s) S_in dy_s
//   dL_s = sum_t M_st - sum_s' M_s's + exp(L_s) (C_s^T S_in) . dy_s - R_s,
//          R_t = exp(L_Q - L_t) dt_t (G^T B_t) . x_t,
//   dL at the chunk's last step also + sum_t R_t + exp(L_Q) <S_in, G>
//   ddt_t = x_t . g_t + a sum_{u >= t} dL_u,  da += sum_t dt_t sum_{u >= t} dL_u.
// 256 threads (16 x 16): Q x Q tiles as rows ty + 16i, columns tx + 16j;
// Q x P as rows ty + 16i, columns tx * 4 + j; Q x N as rows ty + 16i,
// columns tx + 16j (j < 8).
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
  float* sC = smem + GradLayout::c;
  float* sB = smem + GradLayout::b;
  float* sCB = smem + GradLayout::cb;
  float* sA = smem + GradLayout::att;
  float* sW = smem + GradLayout::wm;
  float* sX = smem + GradLayout::x;
  float* sDY = smem + GradLayout::dy;
  float* sS = smem + GradLayout::s;
  float* sG = smem + GradLayout::g;
  float* sL = smem + GradLayout::vecs;  // L
  float* sDt = sL + kGQ;                // dt
  float* sE = sDt + kGQ;                // exp(L)
  float* sEt = sE + kGQ;                // exp(L_Q - L)
  float* sRow = sEt + kGQ;              // sum_t M_st
  float* sInter = sRow + kGQ;           // exp(L_s) (C_s^T S_in) . dy_s
  float* sR = sInter + kGQ;             // R_t
  float* sDdt = sR + kGQ;               // x_t . g_t
  float* sCol = smem + GradLayout::colpart;
  float* sRed = smem + GradLayout::red;

  const int c = blockIdx.x % nc, bi = blockIdx.x / nc;
  const size_t t0 = (size_t)c * Q;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int np4 = round_up(N, 4), pp4 = round_up(P, 4);

  load_tile(sC, kMaxN, kGQ, cm + ((size_t)bi * S + t0) * N, Q, N, vec);
  load_tile(sB, kMaxN, kGQ, bm + ((size_t)bi * S + t0) * N, Q, N, vec);
  __syncthreads();
  {  // C B^T, shared by the heads
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int n = 0; n < np4; n += 4) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = ld4(sC + sw4(ty + 16 * i, n, kMaxN));
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = ld4(sB + sw4(tx + 16 * j, n, kMaxN));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = dot4(cv[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sCB[(ty + 16 * i) * kLdQ + tx + 16 * j] = acc[i][j];
  }

  float db_acc[4][8], dc_acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) db_acc[i][j] = dc_acc[i][j] = 0.0f;

  for (int h = 0; h < H; ++h) {
    __syncthreads();  // C B^T is written; the previous head's reads are done
    const long long bh = (long long)bi * H + h;
    const size_t row0 = (size_t)bh * S + t0;
    const size_t st0 = ((size_t)bh * nc + c) * N * P;
    load_tile(sX, kMaxP, kGQ, x + row0 * P, Q, P, vec);
    load_tile(sDY, kMaxP, kGQ, dy + row0 * P, Q, P, vec);
    load_tile(sS, kMaxP, kMaxN, s_in + st0, N, P, vec);
    load_tile(sG, kMaxP, kMaxN, g_st + st0, N, P, vec);
    if (tid < kGQ) {
      sL[tid] = tid < Q ? lcum[row0 + tid] : 0.0f;
      sDt[tid] = tid < Q ? dt[row0 + tid] : 0.0f;
    }
    __syncthreads();
    if (tid < kGQ) {
      sE[tid] = tid < Q ? expf(sL[tid]) : 0.0f;
      sEt[tid] = tid < Q ? expf(sL[Q - 1] - sL[tid]) : 0.0f;
    }

    {  // 1. D = dy x^T, then A, W and M's row and column sums
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      for (int p = 0; p < pp4; p += 4) {
        float4 dv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dv[i] = ld4(sDY + sw4(ty + 16 * i, p, kMaxP));
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = ld4(sX + sw4(tx + 16 * j, p, kMaxP));
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = dot4(dv[i], xv[j], acc[i][j]);
      }
      float row[4] = {0.f, 0.f, 0.f, 0.f}, col[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = ty + 16 * i;
        const float ls = sL[s];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = tx + 16 * j;
          const bool ok = s < Q && t <= s;
          const float dec = expf(ok ? ls - sL[t] : -1e30f);  // a select, not a branch
          const float wv = dec * sDt[t] * acc[i][j];
          const float cb = sCB[s * kLdQ + t];
          sA[s * kLdQ + t] = cb * dec;
          sW[s * kLdQ + t] = wv;
          const float m = cb * wv;
          row[i] += m;
          col[j] += m;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = half_warp_sum(row[i]);
        if (tx == 0) sRow[ty + 16 * i] = v;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) sCol[ty * kGQ + tx + 16 * j] = col[j];
    }
    __syncthreads();

    {  // 2. g = A^T dy + exp(L_Q - L) G^T B; dx, x . g and R
      float gi[4][4], gs[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) gi[i][j] = gs[i][j] = 0.0f;
      for (int s = 0; s < Q; ++s) {
        const float4 d4 = ld4(sDY + sw4(s, tx * 4, kMaxP));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = sA[s * kLdQ + ty + 16 * i];
          gi[i][0] = fmaf(av, d4.x, gi[i][0]);
          gi[i][1] = fmaf(av, d4.y, gi[i][1]);
          gi[i][2] = fmaf(av, d4.z, gi[i][2]);
          gi[i][3] = fmaf(av, d4.w, gi[i][3]);
        }
      }
      for (int n = 0; n < np4; n += 4) {
        float4 bv[4], gv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) bv[i] = ld4(sB + sw4(ty + 16 * i, n, kMaxN));
#pragma unroll
        for (int u = 0; u < 4; ++u) gv[u] = ld4(sG + sw4(n + u, tx * 4, kMaxP));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float br[4] = {bv[i].x, bv[i].y, bv[i].z, bv[i].w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            gs[i][0] = fmaf(br[u], gv[u].x, gs[i][0]);
            gs[i][1] = fmaf(br[u], gv[u].y, gs[i][1]);
            gs[i][2] = fmaf(br[u], gv[u].z, gs[i][2]);
            gs[i][3] = fmaf(br[u], gv[u].w, gs[i][3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        const float4 x4 = ld4(sX + sw4(t, tx * 4, kMaxP));
        const float et = sEt[t], dtt = sDt[t];
        float g[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) g[j] = fmaf(et, gs[i][j], gi[i][j]);
        if (t < Q && tx * 4 < P) {
          float* out = dx + (row0 + t) * P + tx * 4;
          if (vec) {
            *reinterpret_cast<float4*>(out) =
                make_float4(dtt * g[0], dtt * g[1], dtt * g[2], dtt * g[3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (tx * 4 + j < P) out[j] = dtt * g[j];
          }
        }
        const float4 gv = make_float4(g[0], g[1], g[2], g[3]);
        const float4 sv = make_float4(gs[i][0], gs[i][1], gs[i][2], gs[i][3]);
        const float xg = half_warp_sum(dot4(x4, gv, 0.0f));
        const float xr = half_warp_sum(dot4(x4, sv, 0.0f));
        if (tx == 0) {
          sDdt[t] = xg;
          sR[t] = et * dtt * xr;
        }
      }
    }
    {  // C S_in . dy, for dL
      float cs[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cs[i][j] = 0.0f;
      for (int n = 0; n < np4; n += 4) {
        float4 cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = ld4(sC + sw4(ty + 16 * i, n, kMaxN));
#pragma unroll
        for (int u = 0; u < 4; ++u) sv[u] = ld4(sS + sw4(n + u, tx * 4, kMaxP));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float cr[4] = {cv[i].x, cv[i].y, cv[i].z, cv[i].w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            cs[i][0] = fmaf(cr[u], sv[u].x, cs[i][0]);
            cs[i][1] = fmaf(cr[u], sv[u].y, cs[i][1]);
            cs[i][2] = fmaf(cr[u], sv[u].z, cs[i][2]);
            cs[i][3] = fmaf(cr[u], sv[u].w, cs[i][3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = ty + 16 * i;
        const float4 d4 = ld4(sDY + sw4(s, tx * 4, kMaxP));
        const float v =
            half_warp_sum(dot4(d4, make_float4(cs[i][0], cs[i][1], cs[i][2], cs[i][3]), 0.0f));
        if (tx == 0) sInter[s] = sE[s] * v;
      }
    }
    // 3. db += W^T C + diag(exp(L_Q - L) dt) x G^T: rows t, columns n = tx + 16j
    for (int s = 0; s < Q; ++s) {
      float wv[4], cv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) wv[i] = sW[s * kLdQ + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) cv[j] = sC[sw4(s, tx + 16 * j, kMaxN)];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) db_acc[i][j] = fmaf(wv[i], cv[j], db_acc[i][j]);
    }
    {
      float wt[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) wt[i] = sEt[ty + 16 * i] * sDt[ty + 16 * i];
      for (int p = 0; p < pp4; p += 4) {
        float4 xv[4], gv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = scale4(ld4(sX + sw4(ty + 16 * i, p, kMaxP)), wt[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) gv[j] = ld4(sG + sw4(tx + 16 * j, p, kMaxP));
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) db_acc[i][j] = dot4(xv[i], gv[j], db_acc[i][j]);
      }
    }
    // dc += W B + diag(exp(L)) dy S_in^T: rows s, columns n = tx + 16j
    for (int t = 0; t < Q; ++t) {
      float wv[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) wv[i] = sW[(ty + 16 * i) * kLdQ + t];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = sB[sw4(t, tx + 16 * j, kMaxN)];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) dc_acc[i][j] = fmaf(wv[i], bv[j], dc_acc[i][j]);
    }
    {
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) e[i] = sE[ty + 16 * i];
      for (int p = 0; p < pp4; p += 4) {
        float4 dv[4], sv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) dv[i] = scale4(ld4(sDY + sw4(ty + 16 * i, p, kMaxP)), e[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) sv[j] = ld4(sS + sw4(tx + 16 * j, p, kMaxP));
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) dc_acc[i][j] = dot4(dv[i], sv[j], dc_acc[i][j]);
      }
    }
    {  // <S_in, G>: both tiles share one layout, zero past N and P
      float v = 0.0f;
      for (int i = tid * 4; i < kMaxN * kMaxP; i += kThreads * 4)
        v = dot4(ld4(sS + i), ld4(sG + i), v);
      v = warp_sum(v);
      if (lane == 0) sRed[warp] = v;
    }
    __syncthreads();

    if (warp == 0) {  // 4. dL, its suffix sums over the chunk, ddt and da's share
      float ssg = 0.0f;
#pragma unroll
      for (int k = 0; k < kThreads / 32; ++k) ssg += sRed[k];
      const float r_sum = warp_sum(sR[lane] + sR[lane + 32]);
      float dl[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = lane * 2 + k;
        float colsum = 0.0f;
#pragma unroll
        for (int y = 0; y < 16; ++y) colsum += sCol[y * kGQ + t];
        float v = sRow[t] - colsum + sInter[t] - sR[t];
        if (t == Q - 1) v += r_sum + sE[Q - 1] * ssg;
        dl[k] = t < Q ? v : 0.0f;
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
        ddt[row0 + lane * 2] = fmaf(ah, rc0, sDdt[lane * 2]);
        share = sDt[lane * 2] * rc0;
      }
      if (lane * 2 + 1 < Q) {
        ddt[row0 + lane * 2 + 1] = fmaf(ah, rc1, sDdt[lane * 2 + 1]);
        share = fmaf(sDt[lane * 2 + 1], rc1, share);
      }
      share = warp_sum(share);
      if (lane == 0) da_part[bh * nc + c] = share;
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = ty + 16 * i;
    if (t >= Q) continue;
    const size_t r = ((size_t)bi * S + t0 + t) * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tx + 16 * j;
      if (n < N) {
        db[r + n] = db_acc[i][j];
        dc[r + n] = dc_acc[i][j];
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
  cudaError_t err = opt_in((const void*)ssd_state_kernel<false>, smem_state);
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
  ssd_state_kernel<false><<<dim3((unsigned)n_state), kStateThreads, smem_state, st>>>(
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
// gradient of the state leaving it), da_part of B * H * (S / Q).  Five
// launches in order on the stream: the scan, the forward state walk, the
// reverse one, the gradient kernel and da's reduction.
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
    const int n_tiles = (N + kNT - 1) / kNT;
    const long long n_warps = (long long)B * H * nc;
    const long long n_scan = (n_warps + kThreads / 32 - 1) / (kThreads / 32);
    const long long n_state = (long long)B * H * n_tiles;
    const long long n_grad = (long long)B * nc;
    if (n_scan > 2147483647LL || n_state > 2147483647LL || n_grad > 2147483647LL)
      return (int)cudaErrorInvalidConfiguration;
    const size_t smem_state = sizeof(float) * 2 * state_stage_floats(Q, P);
    const size_t smem_grad = sizeof(float) * GradLayout::total;
    if (smem_state > (size_t)kSmemMax || smem_grad > (size_t)kSmemMax)
      return (int)cudaErrorInvalidConfiguration;
    err = opt_in((const void*)ssd_state_kernel<false>, smem_state);
    if (err == cudaSuccess) err = opt_in((const void*)ssd_state_kernel<true>, smem_state);
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
        reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(s_in) |
        reinterpret_cast<uintptr_t>(g_st) | reinterpret_cast<uintptr_t>(w) |
        reinterpret_cast<uintptr_t>(ez);
    const int vec = N % 4 == 0 && P % 4 == 0 && Q % 4 == 0 && ptrs % 16 == 0;

    ssd_scan_kernel<<<dim3((unsigned)n_scan), kThreads, 0, st>>>(dtf, af, lcum, w, decay, ez,
                                                                 H, S, Q, nc, n_warps);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_state_kernel<false><<<dim3((unsigned)n_state), kStateThreads, smem_state, st>>>(
        xf, bf, w, decay, sf, H, S, P, N, Q, nc, n_tiles, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_state_kernel<true><<<dim3((unsigned)n_state), kStateThreads, smem_state, st>>>(
        dyf, cf, ez, decay, gf, H, S, P, N, Q, nc, n_tiles, vec);
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
