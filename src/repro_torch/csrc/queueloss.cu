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
//   the (F, B, ...) layout those pairs are contiguous and independent, each
//   starting from an empty queue, just as the batched kernel's epochs are.
//
// Which body each entry takes, and why.  Three bodies below:
//   * the E-tiled body: a CTA per (epoch, 128-link E-tile), W re-read once
//     per 8-sub-step chunk, the tiles' partial sums added by a second launch;
//   * the cluster body: one block on an 8-CTA cluster (queueloss_single);
//   * the fleet body: one CTA per epoch or pair that owns all of its links
//     and streams its W once (one launch, no partials).
// queueloss_batched and queueloss_fleet take the fleet body wherever its
// tiles and links fit one CTA's threads and its shared memory one CTA
// (queueloss_fleet_fits; TS <= 120 at C = E = 132): the batched engine's B = 96
// epochs are 96 CTAs, one wave, where the E-tiled body launched a second,
// 97 %-idle E-tile an epoch at E = 132, read W 5 times at TS = 36 and summed
// partials in a second launch (times in PERF.md §6).  Cutting each
// epoch's links over a cluster of 2 or 4 CTAs (to fill the 132 SMs) was
// slower in the same run: each CTA still walks 36 dependent sub-steps, and
// the cluster adds its barriers.  queueloss_single takes the cluster body
// while it fits shared memory.  Past their bodies' limits all three take the
// E-tiled body; queueloss_tiles launches it whatever the shape, for
// comparisons.  The fleet body sums the links in the E-tiled body's order
// for E <= 160, so there the batched entry's bits did not change.
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
// C=E=132) reads 130 MB (39 us) and does 1.81 GFLOP (27 us); its grid of one
// CTA per (fabric, block) pair is counted in 64 bits and refused above
// gridDim.x's limit.
// The single-block call of the streaming controller (TS=36, C=E=132) reads
// 90 KB and does 1.25 MFLOP: bound by the launch and by the latency of its
// dependent steps, not by bytes or operations.
//
// Design of the E-tiled body.  The TPU kernel carries the whole queue vector
// in VMEM scratch across sequential time tiles.  Here one CTA owns one (epoch,
// E-tile) and one thread owns one link, so the queue lives in a register for
// the whole walk and nothing is carried between CTAs.  The CTA stages kSteps
// sub-step demand rows in shared memory; each thread reads its W column once
// per chunk (neighbouring threads, neighbouring addresses), forms the chunk's
// loads with f32 FMAs (no TF32) and runs the queue through them in order.
// Drops and loads are block-reduced per sub-step in a fixed order (warp
// butterfly, then the warps in order) into partials of shape (B, TS, nE); a
// second small kernel sums the nE partials in order.
//
// Design of the single-block body: load-parallel, one launch.  Walking 5
// demand chunks x 132 commodities of dependent W loads in 2 CTAs (the E-tiled
// body at B = 1) then summing 2 partials in a second launch took 0.05 ms.
// One CTA doing all of the work below stays slower than the launch: the 0.63 M
// FMAs of the load run on one SM.  So the block goes to a thread-block cluster
// of kCluster CTAs, CTA r owning the links [r*ES, (r+1)*ES), ES = ceil(E/8):
//   1. each CTA copies the demand, transposed to (C, TS), its W columns and
//      its cap/buf into shared memory with cp.async, all copies in flight at
//      once (one round trip to memory);
//   2. forms its (TS, ES) loads at once: a thread owns one quarter of the
//      commodities, kLoadSteps sub-steps and two neighbouring links, so per
//      commodity it reads a float2 of W and a broadcast float4 of demand for
//      eight f32 FMAs, over its quarter of c in order;
//   3. adds the quarters in order and forms (load - cap) * dt for every
//      (sub-step, link) at once, so that
//   4. the walk of each link's queue through the TS sub-steps (a thread a
//      link, reading kWalk steps ahead) carries only q + that, a max and a
//      min from one step to the next;
//   5. sums drops and loads over its links per sub-step (a thread a
//      sub-step, the links in order);
//   6. after a cluster barrier, CTA r reads every CTA's sums of the
//      sub-steps k = r (mod 8) through distributed shared memory, adds them
//      in rank order and writes the outputs; a last barrier keeps each CTA's
//      shared memory alive until the others have read it.
//
// Design of the fleet body: one CTA per (fabric, block) pair, W read once, one
// launch.  The E-tiled body over the F*B pairs re-reads each W column once per
// 8-sub-step chunk (5 times at TS = 36, 100 MB of W against a 50 MB L2),
// launches a second, 97 %-idle E-tile at E = 132 and sums the tiles' partials
// in a second launch.  Here one CTA owns all E links of one pair:
//   1. it copies the pair's demand once, transposed to (C, TS rounded up to
//      kFleetRows), and its cap/buf into shared memory with cp.async;
//   2. it streams W through shared memory in slabs of kFleetSlab commodities,
//      double-buffered with cp.async (16-byte copies where W's address and row
//      length allow), so the next slab is in flight while this one is used
//      and W leaves device memory once;
//   3. a thread owns kFleetRows sub-steps x 4 neighbouring links of the
//      (TS, E) loads in registers: per commodity two float4s of demand and a
//      float4 of W for 32 f32 FMAs, every commodity in order;
//   4. the loads go to shared memory (over the dead slabs) and a thread a link
//      walks its queue through the TS sub-steps, reading kWalk steps ahead;
//      per sub-step a warp butterfly sums the drops and the loads of the
//      warp's 32 links;
//   5. a thread a sub-step adds the warps' sums in order and writes the pair's
//      outputs: no partials, no second launch.
// Each link's load is summed over c in the E-tiled body's order, and for
// E <= 160 the sums over links fall in its order too (a butterfly per 32
// links, then the warps of the first 128 links, then the rest).  What holds
// this body back on the card is its FMA loop, issued from shared memory, not
// its bytes or its occupancy (PERF.md: more CTAs an SM, 8 x 8 tiles, warp-wide
// demand reads and other shared-memory layouts did not beat it).
// No atomics anywhere: every entry gives the same bits on every call.  Padded
// sub-steps (zero demand) only drain the queue, and threads past E carry no
// link, so neither ever drops.

#include <cooperative_groups.h>
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
queueloss_tiles_kernel(const float* __restrict__ demand,  // (B, TS, C)
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

constexpr int kCluster = 8;         // CTAs of the single-block cluster
constexpr int kSingleThreads = 384;  // threads of each
constexpr int kLoadSteps = 4;        // sub-steps per thread in the load product
constexpr int kLoadLinks = 2;        // links per thread in the load product
constexpr int kParts = 4;            // the commodities, cut in four per load
constexpr int kWalk = 4;             // sub-steps a queue walk reads ahead
// floats of shared memory a CTA can take (227 KB)
constexpr int kSingleSmemFloats = 227 * 1024 / 4;

__host__ __device__ inline int padded_steps(int TS) {
  return (TS + kLoadSteps - 1) / kLoadSteps * kLoadSteps;
}

// Links of each CTA, and the same rounded up to whole link pairs (the row
// length of the CTA's W columns and loads in shared memory).
__host__ __device__ inline int links_per_cta(int E) { return (E + kCluster - 1) / kCluster; }
__host__ __device__ inline int padded_links(int E) {
  return (links_per_cta(E) + kLoadLinks - 1) / kLoadLinks * kLoadLinks;
}

// Floats of shared memory each CTA of the single-block cluster needs: the
// demand (C, KP), its W columns (C, ESP), the kParts partial loads and the
// drops (TS, ESP) each, cap and buf (ESP), and the per-sub-step sums (2, TS).
__host__ inline long long single_smem_floats(int TS, int C, int E) {
  const long long esp = padded_links(E);
  return (long long)C * padded_steps(TS) + (long long)C * esp +
         (kParts + 1LL) * TS * esp + 2 * esp + 2LL * TS;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kSingleThreads)
queueloss_single_kernel(const float* __restrict__ demand,  // (TS, C)
                        const float* __restrict__ w,       // (C, E)
                        const float* __restrict__ cap,     // (E,) Gb/s
                        const float* __restrict__ buf,     // (E,) Gb
                        float dt, float* __restrict__ drop,  // (TS,)
                        float* __restrict__ load,            // (TS,)
                        int TS, int C, int E) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ES = links_per_cta(E), ESP = padded_links(E);
  const int e0 = min(E, rank * ES);
  const int ne = min(E, e0 + ES) - e0;  // this CTA's links [e0, e0 + ne)
  const int KP = padded_steps(TS);
  const size_t plane = (size_t)TS * ESP;  // one (TS, ESP) array

  extern __shared__ float4 smem4[];
  float* dem = reinterpret_cast<float*>(smem4);  // (C, KP), zero past TS
  float* ws = dem + (size_t)C * KP;             // (C, ESP): W[:, e0:e0+ne]
  float* ld = ws + (size_t)C * ESP;             // (kParts, TS, ESP) partial loads
  float* dr = ld + kParts * plane;              // (TS, ESP) drops
  float* cb = dr + plane;                       // cap (ESP), then buf (ESP)
  float* part = cb + 2 * ESP;                   // (2, TS): drop, load sums
  const int tid = threadIdx.x;

  // 1. stage the demand (transposed), the CTA's W columns and cap/buf: every
  //    copy asynchronous, so all of them are in flight at once
  for (int c = tid; c < C; c += kSingleThreads) {
    for (int k = 0; k < TS; ++k) cp_async4(dem + (size_t)c * KP + k, demand + (size_t)k * C + c);
    for (int k = TS; k < KP; ++k) dem[(size_t)c * KP + k] = 0.0f;
  }
  if (ne > 0 && ne <= kSingleThreads) {  // thread (c0, j) copies rows c0, c0 + c_step, ...
    const int c_step = kSingleThreads / ne, j = tid % ne;
    if (tid < c_step * ne)
      for (int c = tid / ne; c < C; c += c_step)
        cp_async4(ws + (size_t)c * ESP + j, w + (size_t)c * E + e0 + j);
  } else {  // more links than threads
    for (int c = 0; c < C; ++c)
      for (int j = tid; j < ne; j += kSingleThreads)
        cp_async4(ws + (size_t)c * ESP + j, w + (size_t)c * E + e0 + j);
  }
  for (int j = tid; j < ne; j += kSingleThreads) {
    cp_async4(cb + j, cap + e0 + j);
    cp_async4(cb + ESP + j, buf + e0 + j);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2. the (TS, ne) loads: a thread per (quarter of c, kLoadSteps sub-steps,
  //    kLoadLinks neighbouring links); per commodity one float2 of W and a
  //    broadcast float4 of demand, f32 FMAs over its quarter of c in order
  const int n_kg = KP / kLoadSteps, n_lg = (ne + kLoadLinks - 1) / kLoadLinks;
  const int c_part = (C + kParts - 1) / kParts;
  const int n_items = kParts * n_kg * n_lg;
  for (int item = tid; item < n_items; item += kSingleThreads) {
    const int p = item / (n_kg * n_lg), rest = item - p * (n_kg * n_lg);
    const int kg = rest / n_lg, j = (rest - kg * n_lg) * kLoadLinks;
    float acc[kLoadSteps][kLoadLinks];
#pragma unroll
    for (int u = 0; u < kLoadSteps; ++u) acc[u][0] = acc[u][1] = 0.0f;
    const float* dk = dem + kg * kLoadSteps;
    const int c_end = min(C, (p + 1) * c_part);
#pragma unroll 4
    for (int c = p * c_part; c < c_end; ++c) {
      const float2 wv = *reinterpret_cast<const float2*>(ws + (size_t)c * ESP + j);
      const float4 d = *reinterpret_cast<const float4*>(dk + (size_t)c * KP);
      acc[0][0] = fmaf(d.x, wv.x, acc[0][0]);
      acc[1][0] = fmaf(d.y, wv.x, acc[1][0]);
      acc[2][0] = fmaf(d.z, wv.x, acc[2][0]);
      acc[3][0] = fmaf(d.w, wv.x, acc[3][0]);
      acc[0][1] = fmaf(d.x, wv.y, acc[0][1]);
      acc[1][1] = fmaf(d.y, wv.y, acc[1][1]);
      acc[2][1] = fmaf(d.z, wv.y, acc[2][1]);
      acc[3][1] = fmaf(d.w, wv.y, acc[3][1]);
    }
    float* ld_p = ld + p * plane;
#pragma unroll
    for (int u = 0; u < kLoadSteps; ++u) {
      const int k = kg * kLoadSteps + u;
      if (k < TS) {
        ld_p[(size_t)k * ESP + j] = acc[u][0];
        if (j + 1 < ne) ld_p[(size_t)k * ESP + j + 1] = acc[u][1];
      }
    }
  }
  __syncthreads();

  // 3. every (sub-step, link) at once: the load, the kParts partials added in
  //    order, into the first partial, and (load - cap) * dt into the second
  for (int i = tid; i < TS * ne; i += kSingleThreads) {
    const int k = i / ne, j = i - k * ne;
    const size_t o = (size_t)k * ESP + j;
    float l = ld[o];
#pragma unroll
    for (int pi = 1; pi < kParts; ++pi) l += ld[pi * plane + o];
    ld[o] = l;
    ld[plane + o] = (l - cb[j]) * dt;
  }
  __syncthreads();

  // 4. each link's queue through the TS sub-steps, in order (a thread a
  //    link), reading kWalk steps ahead of the walk
  const float* inc = ld + plane;  // (load - cap) * dt
  for (int j = tid; j < ne; j += kSingleThreads) {
    const float buf_e = cb[ESP + j];
    float q = 0.0f;  // the queue starts empty at the call
    float next[kWalk];
#pragma unroll
    for (int u = 0; u < kWalk; ++u) next[u] = u < TS ? inc[(size_t)u * ESP + j] : 0.0f;
    for (int k0 = 0; k0 < TS; k0 += kWalk) {
      float cur[kWalk];
#pragma unroll
      for (int u = 0; u < kWalk; ++u) {
        cur[u] = next[u];
        const int k = k0 + kWalk + u;
        next[u] = k < TS ? inc[(size_t)k * ESP + j] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kWalk; ++u) {
        if (k0 + u < TS) {
          const float x = q + cur[u];
          dr[(size_t)(k0 + u) * ESP + j] = fmaxf(x - buf_e, 0.0f);
          q = fminf(fmaxf(x, 0.0f), buf_e);
        }
      }
    }
  }
  __syncthreads();

  // 5. this CTA's sums over its links per sub-step: a thread a sub-step,
  //    the links in order
  for (int k = tid; k < TS; k += kSingleThreads) {
    float d = 0.0f, l = 0.0f;
    for (int j = 0; j < ne; ++j) {
      d += dr[(size_t)k * ESP + j];
      l += ld[(size_t)k * ESP + j];
    }
    part[k] = d;
    part[TS + k] = l;
  }
  cluster.sync();  // every CTA's partial sums are written

  // 6. the cluster's sums, CTAs in rank order (distributed shared memory);
  //    CTA r writes the sub-steps k = r (mod kCluster)
  for (int k = rank + kCluster * tid; k < TS; k += kCluster * kSingleThreads) {
    float d = 0.0f, l = 0.0f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const float* pr = cluster.map_shared_rank(part, r);
      d += pr[k];
      l += pr[TS + k];
    }
    drop[k] = d;
    load[k] = l;
  }
  cluster.sync();  // no CTA leaves while another still reads its partials
}

constexpr int kFleetRows = 8;   // sub-steps per thread in the fleet body
constexpr int kFleetSlab = 16;  // commodities per staged W slab
constexpr int kFleetMaxThreads = 512;

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Threads of the fleet body: one per tile (kFleetRows sub-steps x 4 links) or
// per link, whichever is more, in whole warps.
__host__ inline long long fleet_threads(int TS, int E) {
  const long long tiles = (long long)(round_up(TS, kFleetRows) / kFleetRows) * (round_up(E, 4) / 4);
  const long long n = tiles > E ? tiles : E;
  return n < 32 ? 32 : (n + 31) / 32 * 32;
}

// Floats of the region that holds first the two W slabs, then the loads
// (TS, ESP); and of all of the body's shared memory: the demand (C, KP), that
// region, cap and buf (ESP each) and the per-warp sums of the drops and the
// loads (2, warps, TS).  KP and ESP are TS and E rounded up to kFleetRows and 4.
__host__ __device__ inline long long fleet_region_floats(int TS, int E) {
  const long long esp = round_up(E, 4);
  const long long slabs = 2LL * kFleetSlab * esp, plane = (long long)TS * esp;
  return slabs > plane ? slabs : plane;
}
__host__ inline long long fleet_smem_floats(int TS, int C, int E) {
  return (long long)C * round_up(TS, kFleetRows) + fleet_region_floats(TS, E) +
         2LL * round_up(E, 4) + 2 * (fleet_threads(TS, E) / 32) * TS;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// Copy slab s of a pair's W (its rows [s * kFleetSlab, ...) of (C, E)) into
// dst, row stride ESP: 16-byte copies where `vec` (W's address 16-byte aligned
// and E % 4 == 0, so ESP == E), else 4-byte ones, thread (r0, j) taking the
// rows r0, r0 + nthr / E, ... of link j.
__device__ __forceinline__ void copy_slab(float* dst, const float* w_p, int s, int C, int E,
                                          int ESP, bool vec) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int rows = min(kFleetSlab, C - s * kFleetSlab);
  const float* src = w_p + (size_t)s * kFleetSlab * E;
  if (vec) {
    for (int i = tid; i < rows * E / 4; i += nthr) cp_async16(dst + 4 * i, src + 4 * i);
  } else if (E > 0 && E <= nthr) {
    const int r_step = nthr / E, j = tid % E;
    if (tid < r_step * E)
      for (int r = tid / E; r < rows; r += r_step)
        cp_async4(dst + (size_t)r * ESP + j, src + (size_t)r * E + j);
  } else {
    for (int r = 0; r < rows; ++r)
      for (int j = tid; j < E; j += nthr) cp_async4(dst + (size_t)r * ESP + j, src + (size_t)r * E + j);
  }
}

__global__ void __launch_bounds__(kFleetMaxThreads)
queueloss_fleet_kernel(const float* __restrict__ demand,  // (P, TS, C)
                       const float* __restrict__ w,       // (P, C, E)
                       const float* __restrict__ cap,     // (P, E) Gb/s
                       const float* __restrict__ buf,     // (P, E) Gb
                       float dt, float* __restrict__ drop,  // (P, TS)
                       float* __restrict__ load,            // (P, TS)
                       int TS, int C, int E) {
  const long long pair = blockIdx.x;  // (fabric, block) pair
  const int KP = round_up(TS, kFleetRows), ESP = round_up(E, 4);
  const int nthr = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ float4 smem4[];
  float* dem = reinterpret_cast<float*>(smem4);     // (C, KP), zero past TS
  float* region = dem + (size_t)C * KP;             // W slabs, then the loads
  float* cb = region + fleet_region_floats(TS, E);  // cap (ESP), then buf (ESP)
  float* red = cb + 2 * ESP;                        // (2, warps, TS) sums
  const float* dem_p = demand + (size_t)pair * TS * C;
  const float* w_p = w + (size_t)pair * C * E;

  // 1. the demand (transposed) and cap/buf, in the first copy group
  for (int c = tid; c < C; c += nthr) {
    for (int k = 0; k < TS; ++k) cp_async4(dem + (size_t)c * KP + k, dem_p + (size_t)k * C + c);
    for (int k = TS; k < KP; ++k) dem[(size_t)c * KP + k] = 0.0f;
  }
  for (int j = tid; j < E; j += nthr) {
    cp_async4(cb + j, cap + (size_t)pair * E + j);
    cp_async4(cb + ESP + j, buf + (size_t)pair * E + j);
  }

  // 2. W in slabs of kFleetSlab rows, slab s into buffer s % 2
  const bool vec = (reinterpret_cast<size_t>(w_p) & 15) == 0 && E % 4 == 0;
  const int n_slabs = (C + kFleetSlab - 1) / kFleetSlab;
  for (int s = 0; s < 2; ++s) {
    if (s < n_slabs) copy_slab(region + (size_t)s * kFleetSlab * ESP, w_p, s, C, E, ESP, vec);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // 3. this thread's tile of the loads: kFleetRows sub-steps x 4 links; per
  //    commodity two float4s of demand and a float4 of W for 32 f32 FMAs,
  //    every commodity in order
  const int n_lq = ESP / 4;
  const bool has_tile = tid < (KP / kFleetRows) * n_lq;
  const int kg = has_tile ? tid / n_lq : 0, j4 = has_tile ? (tid - kg * n_lq) * 4 : 0;
  float acc[kFleetRows][4];
#pragma unroll
  for (int u = 0; u < kFleetRows; ++u) acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.0f;
  const float* dk = dem + kg * kFleetRows;
  for (int s = 0; s < n_slabs; ++s) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // slab s has landed
    __syncthreads();
    if (has_tile) {
      const float* ws = region + (size_t)(s & 1) * kFleetSlab * ESP + j4;
      const int c0 = s * kFleetSlab, rows = min(kFleetSlab, C - c0);
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const float4 wv = *reinterpret_cast<const float4*>(ws + (size_t)r * ESP);
        const float4 d0 = *reinterpret_cast<const float4*>(dk + (size_t)(c0 + r) * KP);
        const float4 d1 = *reinterpret_cast<const float4*>(dk + (size_t)(c0 + r) * KP + 4);
        const float dv[kFleetRows] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
        for (int u = 0; u < kFleetRows; ++u) {
          acc[u][0] = fmaf(dv[u], wv.x, acc[u][0]);
          acc[u][1] = fmaf(dv[u], wv.y, acc[u][1]);
          acc[u][2] = fmaf(dv[u], wv.z, acc[u][2]);
          acc[u][3] = fmaf(dv[u], wv.w, acc[u][3]);
        }
      }
    }
    __syncthreads();  // every reader of buffer s % 2 is done
    if (s + 2 < n_slabs)
      copy_slab(region + (size_t)(s & 1) * kFleetSlab * ESP, w_p, s + 2, C, E, ESP, vec);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // the demand and cap/buf have landed even where C == 0

  // 4. the loads over the dead slabs
  float* ld = region;  // (TS, ESP)
  if (has_tile) {
#pragma unroll
    for (int u = 0; u < kFleetRows; ++u) {
      const int k = kg * kFleetRows + u;
      if (k < TS)
        *reinterpret_cast<float4*>(ld + (size_t)k * ESP + j4) =
            make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    }
  }
  __syncthreads();

  // 5. each link's queue through the TS sub-steps in order (a thread a link,
  //    reading kWalk steps ahead); per sub-step the drops and the loads of the
  //    warp's 32 links summed by a warp butterfly, into red
  const int n_link_warps = (E + 31) / 32;  // E <= threads: one link a thread
  if (warp < n_link_warps) {
    const int j = tid;
    const bool live = j < E;
    const float cap_e = live ? cb[j] : 0.0f, buf_e = live ? cb[ESP + j] : 0.0f;
    float* red_d = red + (size_t)warp * TS;
    float* red_l = red + (size_t)(n_link_warps + warp) * TS;
    float q = 0.0f;  // the queue starts empty in every pair
    float next[kWalk];
#pragma unroll
    for (int u = 0; u < kWalk; ++u) next[u] = (live && u < TS) ? ld[(size_t)u * ESP + j] : 0.0f;
    for (int k0 = 0; k0 < TS; k0 += kWalk) {
      float cur[kWalk];
#pragma unroll
      for (int u = 0; u < kWalk; ++u) {
        cur[u] = next[u];
        const int k = k0 + kWalk + u;
        next[u] = (live && k < TS) ? ld[(size_t)k * ESP + j] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kWalk; ++u) {
        if (k0 + u < TS) {  // the same in every lane
          const float x = q + (cur[u] - cap_e) * dt;
          const float d = warp_sum(fmaxf(x - buf_e, 0.0f));
          const float l = warp_sum(cur[u]);
          q = fminf(fmaxf(x, 0.0f), buf_e);
          if (lane == 0) {
            red_d[k0 + u] = d;
            red_l[k0 + u] = l;
          }
        }
      }
    }
  }
  __syncthreads();

  // 6. per sub-step the warps' sums in order: the pair's outputs
  for (int k = tid; k < TS; k += nthr) {
    float d = 0.0f, l = 0.0f;
    for (int wi = 0; wi < n_link_warps; ++wi) {
      d += red[(size_t)wi * TS + k];
      l += red[(size_t)(n_link_warps + wi) * TS + k];
    }
    drop[(size_t)pair * TS + k] = d;
    load[(size_t)pair * TS + k] = l;
  }
}

__global__ void noop_kernel() {}

// Launch the E-tiled body over `pairs` independent queue walks, then the
// partials pass.  Grid sizes are formed in 64 bits: a grid wider than
// gridDim.x allows is refused, never truncated.
int launch_tiles(const void* demand, const void* w, const void* cap, const void* buf, float dt,
                 void* drop, void* load, void* drop_part, void* load_part, long long pairs,
                 int TS, int C, int E, void* stream) {
  if (pairs < 0 || TS < 0 || C < 0 || E < 0) return (int)cudaErrorInvalidValue;
  if (pairs == 0 || TS == 0) return 0;
  if (drop_part == nullptr || load_part == nullptr) return (int)cudaErrorInvalidValue;
  const int n_etiles = E > 0 ? (E + kThreads - 1) / kThreads : 1;
  const long long n_ctas = pairs * n_etiles;
  const long long rows = pairs * TS;
  const int threads = 256;
  const long long n_sum_ctas = (rows + threads - 1) / threads;
  if (n_ctas > kMaxGridX || n_sum_ctas > kMaxGridX) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)kSteps * C * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        queueloss_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  queueloss_tiles_kernel<<<dim3((unsigned)n_ctas), kThreads, smem, s>>>(
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

// Launch the fleet body over `pairs` queue walks, one CTA a pair.  The grid
// is formed in 64 bits and refused above gridDim.x's limit.
int launch_fleet(const void* demand, const void* w, const void* cap, const void* buf, float dt,
                 void* drop, void* load, long long pairs, int TS, int C, int E, void* stream) {
  if (pairs > kMaxGridX) return (int)cudaErrorInvalidConfiguration;
  if (pairs == 0 || TS == 0) return 0;
  const size_t smem = (size_t)fleet_smem_floats(TS, C, E) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        queueloss_fleet_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  queueloss_fleet_kernel<<<dim3((unsigned)pairs), (unsigned)fleet_threads(TS, E), smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(demand), static_cast<const float*>(w),
      static_cast<const float*>(cap), static_cast<const float*>(buf), dt,
      static_cast<float*>(drop), static_cast<float*>(load), TS, C, E);
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

// 1 if a bucket of (TS, C) blocks under (C, E) weights takes the fleet body
// (one CTA per pair, one launch; the batched entry's epochs are its pairs),
// 0 if it takes the E-tiled body and its partials pass.
int queueloss_fleet_fits(int TS, int C, int E) {
  return TS >= 0 && C >= 0 && E >= 0 && fleet_threads(TS, E) <= kFleetMaxThreads &&
         fleet_smem_floats(TS, C, E) <= kSingleSmemFloats;
}

// Bytes of shared memory the fleet body takes at (TS, C, E).
long long queueloss_fleet_smem_bytes(int TS, int C, int E) {
  return fleet_smem_floats(TS, C, E) * (long long)sizeof(float);
}

// B epochs: demand (B, TS, C), w (B, C, E), cap/buf (B, E); outputs (B, TS)
// each; the queue starts empty in every epoch.  drop_part/load_part, (B, TS,
// nE) each, are read only where the shape does not fit the fleet body (they
// may be null where it does).
int queueloss_batched(const void* demand, const void* w, const void* cap, const void* buf,
                      float dt, void* drop, void* load, void* drop_part, void* load_part,
                      int B, int TS, int C, int E, void* stream) {
  if (B < 0 || TS < 0 || C < 0 || E < 0) return (int)cudaErrorInvalidValue;
  if (!queueloss_fleet_fits(TS, C, E))
    return launch_tiles(demand, w, cap, buf, dt, drop, load, drop_part, load_part, B, TS, C, E,
                        stream);
  return launch_fleet(demand, w, cap, buf, dt, drop, load, B, TS, C, E, stream);
}

// The E-tiled body and its partials pass over B epochs whatever the shape
// (what the batched entry launched before it took the fleet body; the
// partials are required): for comparisons only.
int queueloss_tiles(const void* demand, const void* w, const void* cap, const void* buf,
                    float dt, void* drop, void* load, void* drop_part, void* load_part, int B,
                    int TS, int C, int E, void* stream) {
  return launch_tiles(demand, w, cap, buf, dt, drop, load, drop_part, load_part, B, TS, C, E,
                      stream);
}

// 1 if one (TS, C) block under a (C, E) W takes the single-block body (one
// launch, no partials), 0 if it takes the E-tiled body over one pair.
int queueloss_single_fits(int TS, int C, int E) {
  return TS >= 0 && C >= 0 && E >= 0 && single_smem_floats(TS, C, E) <= kSingleSmemFloats;
}

// One (TS, C) block under one (C, E) weight matrix; the queue starts empty.
// drop_part/load_part are read only where the block does not fit (they may
// be null where it does).
int queueloss_single(const void* demand, const void* w, const void* cap, const void* buf,
                     float dt, void* drop, void* load, void* drop_part, void* load_part,
                     int TS, int C, int E, void* stream) {
  if (TS < 0 || C < 0 || E < 0) return (int)cudaErrorInvalidValue;
  if (!queueloss_single_fits(TS, C, E))
    return launch_tiles(demand, w, cap, buf, dt, drop, load, drop_part, load_part, 1, TS, C, E,
                        stream);
  if (TS == 0) return 0;
  const size_t smem = (size_t)single_smem_floats(TS, C, E) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        queueloss_single_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  queueloss_single_kernel<<<kCluster, kSingleThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(demand), static_cast<const float*>(w),
      static_cast<const float*>(cap), static_cast<const float*>(buf), dt,
      static_cast<float*>(drop), static_cast<float*>(load), TS, C, E);
  return (int)cudaGetLastError();
}

// An empty kernel on the stream: the floor under any launch through ctypes.
int queueloss_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// F fabrics x B blocks: demand (F, B, TS, C), w (F, B, C, E), cap/buf (F, B, E);
// outputs (F, B, TS) each.  The queue starts empty in every (fabric, block)
// pair.  drop_part/load_part, (F, B, TS, nE) each, are read only where the
// bucket does not fit the fleet body (they may be null where it does).
int queueloss_fleet(const void* demand, const void* w, const void* cap, const void* buf,
                    float dt, void* drop, void* load, void* drop_part, void* load_part, int F,
                    int B, int TS, int C, int E, void* stream) {
  if (F < 0 || B < 0 || TS < 0 || C < 0 || E < 0) return (int)cudaErrorInvalidValue;
  const long long pairs = (long long)F * B;
  if (!queueloss_fleet_fits(TS, C, E))
    return launch_tiles(demand, w, cap, buf, dt, drop, load, drop_part, load_part, pairs, TS, C,
                        E, stream);
  return launch_fleet(demand, w, cap, buf, dt, drop, load, pairs, TS, C, E, stream);
}

}  // extern "C"
