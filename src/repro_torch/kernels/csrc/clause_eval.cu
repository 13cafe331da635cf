// Clause evaluation kernels for sm_90a: three entry points, each its own
// launch with its own count in _build.py.
//
//   fused_votes_batched  client-batched clause eval + Eq.-1 vote;
//   fused_votes          the same for one model (N = 1 of one kernel);
//   clause_outputs       violation count, then == 0 (further down).
//
// ---------------------------------------------------------------------------
// votes_mma_kernel, behind fused_votes_batched and fused_votes, replaces
// src/repro/kernels/clause_eval.py::fused_votes_batched_pallas (body
// _votes_batched_kernel) and ::fused_votes_pallas (body _votes_kernel):
// include (N,C,m,L) 0/1 bytes x lits (N,B,L) int32 x wpol (N,C,m) int32
// -> unclipped votes (N,B,C) int32.  A clause fires when none of its
// included literals is 0 in the sample; in predict mode an empty clause
// (nothing included) is silenced by zeroing its weight.
//
// What bounds it on an H100: reading the include plane, N*C*m*L bytes
// (94 MB for 20 clients at C = 10, m = 300, L = 1568: 28 us at 3.35 TB/s;
// 4.7 MB, 1.4 us, for one model), against 2*N*B*C*m*L {0,1} operations
// (3.8 us at the int8 tensor-core peak for B = 40).  What holds it back
// is each block's own chain of work, not the card's byte rate: at
// B = 40, 70 blocks (one an SM) already take most of the time that 200
// take (chip_smoke.py's sweep): staging the B x L int32 literals, then
// some 75 steps a warp of shared-memory reads and mma.sync.  More include
// bytes in flight (the ring below, against two chunks held in registers)
// did not move kernel 2 measurably.  At B = 1 (the serving verifier) one
// model's plane is too small to fill the card, and the launch, the
// cluster barriers and the vote reduction take most of the time.
//
// Design:
// * One thread-block cluster per (class c, client n): grid (G, C, N),
//   cluster (G, 1, 1).  The cluster's G blocks split the class's m clauses
//   into 16-row tiles; plan_votes (votes_plan.h) sizes G so that N*C*G
//   fills the SMs: 8 for one model of 10 classes, 1 (a plain launch) for
//   20 clients x 10 classes.
// * Each block stages (1 - lit) of all B samples (up to `pass` samples;
//   more take further passes inside the block) as bytes in shared memory,
//   formed from the int32 literals in the kernel, zero past L: no host
//   copy of either operand.  With more than one n-tile and more than one
//   block in the cluster, each block stages a slice of the samples and
//   copies the others' slices from their shared memory (DSMEM).
// * Each warp streams its clause tiles' include rows through its own ring
//   of `stages` shared-memory stages, one stage a 64-literal chunk of 16
//   rows (1 KB).  The warp's lanes fill a stage with 16-byte cp.async
//   copies (zero-filled past L and past m) and each stage's mbarrier
//   completes when all 32 lanes' copies have landed
//   (cp.async.mbarrier.arrive.noinc); the warp reads a stage after its
//   barrier's phase flips and refills it `stages - 1` chunks ahead, across
//   tile boundaries.  So up to `stages - 1` KB a warp are in flight without
//   holding a register, and the first chunks are in flight while the
//   samples stage.  The plan takes as many stages (2 to 16) as fit one
//   block an SM when the grid has no more blocks than SMs (one model: all
//   of a warp's chunks at once), else as keep two blocks an SM.  Rows
//   that are not 16-byte aligned (L % 16 != 0) are loaded byte-wise and
//   stored by the lanes, which then arrive on the same barrier.  Every
//   include byte is read once per pass, so once per call when B fits one
//   pass (up to 128 samples).
// * Violation counts run on the tensor cores, exactly:
//   mma.sync m16n8k32 u8 x u8 -> s32, A = 16 include rows, B = 8 samples'
//   (1 - lit), the same 16-literal permutation on both sides (a dot product
//   does not care about the order of k).  An OR over the read include
//   words gives the empty-clause rule.
// * At small B a tile's chunks are split over `ks` warps of the block;
//   their counts are added in shared memory before the == 0 test.
// * Each warp adds wpol over its fired clauses per sample; the block adds
//   its warps' sums in a fixed order and writes them into rank 0's shared
//   memory through distributed shared memory; after one cluster barrier
//   rank 0 adds the blocks in rank order and writes each vote once.  No
//   atomics, no memset: one launch per call, the same result on every run.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "votes_plan.h"

namespace cg = cooperative_groups;
using namespace vote_layout;

namespace {

// 16 bytes of one include row from byte k, zero past L, loaded byte-wise
// (a row that is not 16-byte aligned).
__device__ __forceinline__ uint4 load16_bytes(const uint8_t* __restrict__ row,
                                              int k, int L) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < 16 && k + i < L; ++i)
    w[i >> 2] |= static_cast<uint32_t>(__ldg(row + k + i)) << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The mbarrier of a ring stage: 32 arrivals (the warp's lanes) a phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

// Arrive once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

// Arrive now (release: this thread's shared stores before it are seen by
// the threads that wait on the phase).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          smem_addr(bar)) : "memory");
}

// Wait (acquire) until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// 16 bytes from global to shared, asynchronously; `bytes` < 16 zero-fills
// the rest (0: no read at all).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ uint4 lds128(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ uint32_t or_words(uint4 q) {
  return q.x | q.y | q.z | q.w;
}

// The two halves of a cluster barrier: every thread of every block of the
// cluster arrives, then waits for all the others' arrivals.  The relaxed
// arrive orders nothing before it; the default one releases this thread's
// earlier memory accesses to the threads that wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// c += A (16 x 32, row) * B (32 x 8, col), u8 operands, s32 accumulator.
__device__ __forceinline__ void mma_u8(int32_t (&c)[4], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A 16-byte load of p when `pred`, else (1, 1, 1, 1) and no access.
__device__ __forceinline__ int4 ldg_if(const int32_t* p, bool pred) {
  int4 q = make_int4(1, 1, 1, 1);
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %4, 0;\n"
      " @p ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%5];\n}\n"
      : "+r"(q.x), "+r"(q.y), "+r"(q.z), "+r"(q.w)
      : "r"((int)pred), "l"(p));
  return q;
}

__device__ __forceinline__ uint32_t pack_nlit(int4 q) {
  return (uint32_t)(uint8_t)(1 - q.x) | (uint32_t)(uint8_t)(1 - q.y) << 8 |
         (uint32_t)(uint8_t)(1 - q.z) << 16 |
         (uint32_t)(uint8_t)(1 - q.w) << 24;
}

// Stage (1 - lit) of `rows` samples as bytes: `alloc` rows of `stride`
// bytes, zero past L and past `rows`.  Word i of the staged plane is
// literals 4k..4k+3 of sample b.  The `rows` rows are walked in units of
// one word per thread, starting at unit `rot`: the blocks that stage the same
// samples (a model's classes, a cluster's blocks) start at different
// units, so they do not all ask the same L2 lines for the same words at
// once.  Each thread keeps kInFlight 16-byte loads in flight (32 KB a
// block), issued before any is used (predicated, so no branch separates
// them).  Words at a ragged or unaligned L edge take the byte-wise path
// after them.
template <bool ALIGNED>
__device__ __forceinline__ void stage_nlit(uint32_t* __restrict__ s_nlit,
                                           const int32_t* __restrict__ lits,
                                           int rows, int alloc, int stride,
                                           int L, unsigned rot) {
  constexpr int kInFlight = 8;
  const int words = stride >> 2;
  const int total = rows * words;      // the rows past `rows` are zero
  for (int i = total + threadIdx.x; i < alloc * words; i += kThreads)
    s_nlit[i] = 0u;
  const int units = (total + kThreads - 1) / kThreads;
  const int first = (int)(rot % (unsigned)units);
  for (int u0 = 0; u0 < units; u0 += kInFlight) {
    int4 q[kInFlight];
    int idx[kInFlight];
    bool full[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      int unit = first + u0 + u;
      unit -= unit >= units ? units : 0;
      const int i = unit * kThreads + threadIdx.x;
      const int b = i / words;
      const int k = 4 * (i - b * words);
      idx[u] = u0 + u < units && i < total ? i : -1;
      full[u] = ALIGNED && idx[u] >= 0 && k + 4 <= L;
      q[u] = ldg_if(lits + (size_t)b * L + k, full[u]);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = idx[u];
      if (i < 0) continue;
      uint32_t v = 0u;
      if (full[u]) {
        v = pack_nlit(q[u]);
      } else {
        const int b = i / words;
        const int k = 4 * (i - b * words);
        for (int e = 0; e < 4 && k + e < L; ++e)
          v |= (uint32_t)(uint8_t)(1 - __ldg(lits + (size_t)b * L + k + e))
               << (8 * e);
      }
      s_nlit[i] = v;
    }
  }
}

// Copy the staged sample rows [0, rows) that other blocks of the cluster
// staged (block q holds [q * rows / K, (q + 1) * rows / K)) from their
// shared memory into this block's, 16 bytes at a time, kBatch loads in
// flight a thread.
__device__ __forceinline__ void gather_rows(cg::cluster_group& cluster,
                                            uint8_t* s_nlit, int rows,
                                            int stride, int K, int rank) {
  constexpr int kBatch = 4;
  const int per_row = stride / 16;
  const int total = rows * per_row;
  uint4* local = reinterpret_cast<uint4*>(s_nlit);
  for (int i0 = threadIdx.x; i0 < total; i0 += kThreads * kBatch) {
    uint4 v[kBatch];
    int at[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      const int r = i / per_row;
      const int q = ((r + 1) * K - 1) / rows;        // the row's stager
      at[u] = i < total && q != rank ? i : -1;
      if (at[u] >= 0)
        v[u] = reinterpret_cast<const uint4*>(
            cluster.map_shared_rank(s_nlit, q))[i];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (at[u] >= 0) local[at[u]] = v[u];
  }
}

// Fill one ring stage with chunk kc of the 16 rows from `r0` of `bank`:
// row r's 64 bytes at r * 64, zero past L and past m.  Lane l moves the
// 16-byte pieces l and l + 32 (rows l / 4 and l / 4 + 8), then arrives on
// the stage's barrier.
template <bool ALIGNED>
__device__ __forceinline__ void fill_stage(uint8_t* stage, uint64_t* bar,
                                           const uint8_t* __restrict__ bank,
                                           int r0, int kc, int m, int L,
                                           int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int piece = lane + 32 * h;
    const int r = r0 + (piece >> 2);
    const int k = kc * kChunk + 16 * (piece & 3);
    uint8_t* dst = stage + 16 * piece;
    if (ALIGNED) {                       // L % 16 == 0: in or wholly past L
      const bool in = r < m && k < L;
      cp_async16(dst, in ? bank + (size_t)r * L + k : bank, in ? 16 : 0);
    } else {
      *reinterpret_cast<uint4*>(dst) =
          r < m ? load16_bytes(bank + (size_t)r * L, k, L)
                : make_uint4(0, 0, 0, 0);
    }
  }
  if (ALIGNED)
    mbar_arrive_cp_async(bar);
  else
    mbar_arrive(bar);
}

// NT: n-tiles of 8 samples per pass the registers hold (two blocks an SM
// up to 8); ALIGNED: L is a positive multiple of 16 and both planes start
// 16-byte aligned.
template <int NT, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, NT <= 8 ? 2 : 1)
votes_mma_kernel(const uint8_t* __restrict__ inc,    // (N, C, m, L)
                 const int32_t* __restrict__ lits,   // (N, B, L)
                 const int32_t* __restrict__ wpol,   // strides sN, sC, sJ
                 int32_t* __restrict__ votes,        // (N, B, C)
                 int C, int m, int L, int B, long long sN, long long sC,
                 long long sJ, int predict, int ks, int pass, int stages) {
  constexpr int VS = NT > 8 ? 2 : 1;   // vote sums a lane keeps
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ VoteShared sh;

  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.y;
  const size_t n = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;             // mma group: row g / g + 8, sample g
  const int t = lane & 3;              // mma thread in group
  const int nchunks = (L + kChunk - 1) / kChunk;
  const int stride = row_stride(L);
  uint8_t* s_nlit = smem;
  int32_t* s_cnt = reinterpret_cast<int32_t*>(smem + (size_t)pass * stride);
  uint8_t* ring = smem + (size_t)pass * stride +
                  (ks > 1 ? count_bytes(NT) : 0) +
                  (size_t)warp * stages * kStageBytes;
  uint64_t* bar = sh.bar[warp];

  // this block's 16-row clause tiles; warp = (slot, K part)
  const int tiles = (m + 15) >> 4;
  const int t0 = rank * tiles / G;
  const int t1 = (rank + 1) * tiles / G;
  const int slots = kWarps / ks;
  const int slot = warp / ks;
  const int kp = warp - slot * ks;
  const int iters = (t1 - t0 + slots - 1) / slots;
  const int live_iters = t1 - t0 > slot ? (t1 - t0 - slot + slots - 1) / slots
                                        : 0;
  const int nck = kp < nchunks ? (nchunks - kp + ks - 1) / ks : 0;
  const uint8_t* bank = inc + (n * C + c) * (size_t)m * L;
  const int32_t* wrow = wpol + (long long)n * sN + (long long)c * sC;

  if (lane == 0)
    for (int s = 0; s < stages; ++s) mbar_init(&bar[s], 32);
  __syncthreads();                     // the barriers before any arrival
  // The ring: the warp's items are (tile iteration, chunk j) in order;
  // the next to fill and the next to read, their stages and the read
  // phase's parity run on across passes.
  int fill_it = 0, fill_j = 0, fill_at = 0, read_at = 0;
  uint32_t parity = 0u;
  auto fill_next = [&]() {
    if (nck == 0 || fill_it >= live_iters) return;
    fill_stage<ALIGNED>(ring + fill_at * kStageBytes, &bar[fill_at], bank,
                        (t0 + slot + fill_it * slots) * 16, kp + fill_j * ks,
                        m, L, lane);
    if (++fill_at == stages) fill_at = 0;
    if (++fill_j == nck) fill_j = 0, ++fill_it;
  };
  // the cluster's shared memory may be read or written once every block
  // has started
  cluster_arrive_relaxed();

  for (int p0 = 0; p0 < B; p0 += pass) {
    const int rows = min(pass, B - p0);
    const int nt = (rows + 7) >> 3;
    // the first chunks are in flight while the samples stage
    fill_it = fill_j = 0;
    for (int s = 0; s + 1 < stages; ++s) fill_next();
    // with more than one n-tile, each block of the cluster stages its
    // slice of the samples and copies the others' from their shared
    // memory (uniform in the cluster)
    const bool share = G > 1 && rows > 8;
    const unsigned rot = 7u * (blockIdx.x + gridDim.x * blockIdx.y);
    const int32_t* plits = lits + (n * B + p0) * (size_t)L;
    if (share) {
      const int lo = rank * rows / G, hi = (rank + 1) * rows / G;
      if (hi > lo)
        stage_nlit<ALIGNED>(reinterpret_cast<uint32_t*>(s_nlit + lo * stride),
                            plits + (size_t)lo * L, hi - lo, hi - lo, stride,
                            L, rot);
      for (int i = rows * stride / 4 + threadIdx.x; i < nt * 8 * stride / 4;
           i += kThreads)
        reinterpret_cast<uint32_t*>(s_nlit)[i] = 0u;
      cluster_wait();                  // the arrive before this pass
      cluster_arrive();
      cluster_wait();                  // every slice is staged
      gather_rows(cluster, s_nlit, rows, stride, G, rank);
    } else {
      stage_nlit<ALIGNED>(reinterpret_cast<uint32_t*>(s_nlit), plits, rows,
                          nt * 8, stride, L, rot);
    }
    __syncthreads();

    int32_t vsum[VS][2];
#pragma unroll
    for (int j = 0; j < VS; ++j) vsum[j][0] = vsum[j][1] = 0;

    for (int it = 0; it < iters; ++it) {
      const bool live = it < live_iters;           // uniform in the warp
      const int r0 = (t0 + slot + it * slots) * 16 + g;
      const int r1 = r0 + 8;
      int32_t cnt[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i)
        cnt[i][0] = cnt[i][1] = cnt[i][2] = cnt[i][3] = 0;
      uint32_t any0 = 0u, any1 = 0u;
      // the tile's weights load while its chunks are counted
      int32_t w0 = 0, w1 = 0;
      if (live && kp == 0) {
        if (r0 < m) w0 = __ldg(wrow + (long long)r0 * sJ);
        if (r1 < m) w1 = __ldg(wrow + (long long)r1 * sJ);
      }
      if (live) {
        for (int j = 0; j < nck; ++j) {
          fill_next();                 // the stage read one step ago
          mbar_wait(&bar[read_at], parity);
          const uint8_t* st = ring + read_at * kStageBytes + 16 * t;
          const uint4 a0 = lds128(st + g * kChunk);
          const uint4 a1 = lds128(st + (g + 8) * kChunk);
          any0 |= or_words(a0);
          any1 |= or_words(a1);
          const uint8_t* sb =
              s_nlit + (size_t)g * stride + (kp + j * ks) * kChunk + 16 * t;
#pragma unroll
          for (int i = 0; i < NT; ++i) {
            if (i < nt) {
              const uint4 b = lds128(sb + (size_t)i * 8 * stride);
              mma_u8(cnt[i], a0.x, a1.x, a0.y, a1.y, b.x, b.y);
              mma_u8(cnt[i], a0.z, a1.z, a0.w, a1.w, b.z, b.w);
            }
          }
          __syncwarp();                // every lane has read the stage
          if (++read_at == stages) read_at = 0, parity ^= 1u;
        }
      }
      if (ks > 1) {                                 // uniform in the block
        int32_t* mine = s_cnt + (size_t)warp * NT * 128;
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int r = 0; r < 4; ++r) mine[(i * 4 + r) * 32 + lane] = cnt[i][r];
        sh.any[warp][0][lane] = any0;
        sh.any[warp][1][lane] = any1;
        __syncthreads();
        if (kp == 0) {
          for (int q = 1; q < ks; ++q) {
            const int32_t* other = s_cnt + (size_t)(warp + q) * NT * 128;
#pragma unroll
            for (int i = 0; i < NT; ++i)
#pragma unroll
              for (int r = 0; r < 4; ++r)
                cnt[i][r] += other[(i * 4 + r) * 32 + lane];
            any0 |= sh.any[warp + q][0][lane];
            any1 |= sh.any[warp + q][1][lane];
          }
        }
        __syncthreads();
      }
      if (live && kp == 0) {
        // rows g and g + 8: OR over the quad that holds their words
        any0 |= __shfl_xor_sync(0xffffffffu, any0, 1);
        any0 |= __shfl_xor_sync(0xffffffffu, any0, 2);
        any1 |= __shfl_xor_sync(0xffffffffu, any1, 1);
        any1 |= __shfl_xor_sync(0xffffffffu, any1, 2);
        if (predict && any0 == 0u) w0 = 0;
        if (predict && any1 == 0u) w1 = 0;
        // cnt[i]: rows (g, g, g+8, g+8) x samples (2t, 2t+1, 2t, 2t+1);
        // the tile's vote per sample is the sum over the 8 groups, kept
        // by the lanes of group i % 8
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          if (i < nt) {
            int32_t v0 = (cnt[i][0] == 0 ? w0 : 0) + (cnt[i][2] == 0 ? w1 : 0);
            int32_t v1 = (cnt[i][1] == 0 ? w0 : 0) + (cnt[i][3] == 0 ? w1 : 0);
#pragma unroll
            for (int d = 4; d < 32; d <<= 1) {
              v0 += __shfl_xor_sync(0xffffffffu, v0, d);
              v1 += __shfl_xor_sync(0xffffffffu, v1, d);
            }
            if (g == (i & 7)) {
              vsum[i >> 3][0] += v0;
              vsum[i >> 3][1] += v1;
            }
          }
        }
      }
    }

    // the warp's sums, then the block's over its warps in order
#pragma unroll
    for (int j = 0; j < VS; ++j) {
      const int i = g + 8 * j;
      if (i < nt) {
        sh.vote[warp][i * 8 + 2 * t] = vsum[j][0];
        sh.vote[warp][i * 8 + 2 * t + 1] = vsum[j][1];
      }
    }
    __syncthreads();
    // the block's sum goes into rank 0's row `rank` through distributed
    // shared memory, once rank 0 has started (first pass) or has read the
    // previous pass's rows (later passes); the sharing barrier above has
    // said so already
    if (!share) cluster_wait();
    if (threadIdx.x < rows) {
      int32_t v = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += sh.vote[w][threadIdx.x];
      cluster.map_shared_rank(&sh.part[0][0], 0)[rank * kMaxPass +
                                                 threadIdx.x] = v;
    }
    cluster.sync();
    // rank 0 adds the cluster's blocks in rank order and writes each vote
    if (rank == 0 && threadIdx.x < rows) {
      int32_t v = 0;
      for (int r = 0; r < G; ++r) v += sh.part[r][threadIdx.x];
      votes[(n * B + p0 + threadIdx.x) * (size_t)C + c] = v;
    }
    // rank 0's reads above, and every block's reads of the others'
    // samples, come before any block's next writes
    if (p0 + pass < B) cluster_arrive();
  }
}

// The SM count of the current device, read once per device.
cudaError_t sm_count(int* sms) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    e = cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
  }
  *sms = cached[dev];
  return cudaSuccess;
}

template <int NT, bool ALIGNED>
cudaError_t launch_votes_nt(const uint8_t* inc, const int32_t* lits,
                            const int32_t* wpol, int32_t* votes, int N, int C,
                            int m, int L, int B, long long sN, long long sC,
                            long long sJ, int predict, const VotePlan& p,
                            cudaStream_t stream) {
  auto* kernel = votes_mma_kernel<NT, ALIGNED>;
  // attributes are set once per instantiation, and again only to grow
  // (static and dynamic shared memory above 48 KB need the opt-in)
  static int smem_set = -1;
  if (p.smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return e;
    smem_set = p.smem;
  }
  const dim3 grid(p.cluster, C, N);
  if (p.cluster == 1) {        // a plain launch: each block its own cluster
    kernel<<<grid, kThreads, p.smem, stream>>>(inc, lits, wpol, votes, C, m,
                                               L, B, sN, sC, sJ, predict, p.ks,
                                               p.pass, p.stages);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kernel, inc, lits, wpol, votes, C, m, L, B, sN, sC,
                     sJ, predict, p.ks, p.pass, p.stages);
  return cudaGetLastError();
}

template <bool ALIGNED>
cudaError_t launch_votes_aligned(const uint8_t* inc, const int32_t* lits,
                                 const int32_t* wpol, int32_t* votes, int N,
                                 int C, int m, int L, int B, long long sN,
                                 long long sC, long long sJ, int predict,
                                 const VotePlan& p, cudaStream_t stream) {
#define VOTES_NT(K)                                                          \
  case K:                                                                    \
    return launch_votes_nt<K, ALIGNED>(inc, lits, wpol, votes, N, C, m, L, B, \
                                       sN, sC, sJ, predict, p, stream);
  switch (p.nt) {
    VOTES_NT(1)
    VOTES_NT(2)
    VOTES_NT(4)
    VOTES_NT(8)
    VOTES_NT(16)
    default: return cudaErrorInvalidValue;
  }
#undef VOTES_NT
}

cudaError_t launch_votes(const void* inc, const void* lits, const void* wpol,
                         void* votes, int N, int C, int m, int L, int B,
                         long long sN, long long sC, long long sJ,
                         int predict, void* stream) {
  if (N == 0 || C == 0 || B == 0) return cudaGetLastError();
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  VotePlan p;
  if (!plan_votes(N, C, m, L, B, sms, &p)) return cudaErrorInvalidValue;
  const auto* i8 = static_cast<const uint8_t*>(inc);
  const auto* l32 = static_cast<const int32_t*>(lits);
  const auto* w32 = static_cast<const int32_t*>(wpol);
  auto* out = static_cast<int32_t*>(votes);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool aligned = L > 0 && L % 16 == 0 &&
                       (reinterpret_cast<uintptr_t>(inc) |
                        reinterpret_cast<uintptr_t>(lits)) % 16 == 0;
  return aligned
      ? launch_votes_aligned<true>(i8, l32, w32, out, N, C, m, L, B, sN, sC,
                                   sJ, predict, p, s)
      : launch_votes_aligned<false>(i8, l32, w32, out, N, C, m, L, B, sN, sC,
                                    sJ, predict, p, s);
}

// ---------------------------------------------------------------------------
// clause_outputs: replaces src/repro/kernels/clause_eval.py::
// clause_outputs_pallas (body _clause_kernel): include (NB, CM, L) x lits
// (NB, B, L) -> fired (NB, B, CM) int32, for NB stacked models (NB = 1 for
// one model).  A clause fires iff none of its included literals is 0 in
// the sample; in predict mode an empty clause does not fire.
//
// What bounds it: reading the include plane, NB*CM*L bytes (94 MB for 20
// clients of 3000 clauses at L = 1568, 28 us at 3.35 TB/s), against
// 2*NB*B*CM*L {0,1} operations.  The training scan calls it with B = 1
// once per sample, so it is read once per call and never re-read.
//
// Design: one warp per clause, kWarps clauses per block, a block per
// (clause group, tile of BT samples, model).  The tile's (1 - lit) rows
// are staged in shared memory (BT = 1 in training: the one row) as 32-bit
// words of four 0/1 bytes, and count_row gives the counts and the
// empty-clause rule.  The caller pads L to a multiple of 4 with zero bytes
// in both operands (a zero byte is neither included nor violated).

constexpr int kBT = 8;      // samples per block when B > 1

// Stage `nb` rows of W words from `src` into shared `dst` (BT rows), with
// zero words for the rows past `nb`.
template <int BT>
__device__ __forceinline__ void stage_rows(uint32_t* dst,
                                           const uint32_t* __restrict__ src,
                                           int nb, int W) {
  for (int i = threadIdx.x; i < BT * W; i += blockDim.x) {
    const int b = i / W;
    dst[i] = b < nb ? src[(size_t)b * W + (i - b * W)] : 0u;
  }
}

// One warp, one clause row: the violated literals of each staged sample,
// summed over the warp (every lane gets the sums), and whether the row
// includes anything.  Lanes stride over the row's words (coalesced);
// popc(inc & nlit) counts four 0/1 bytes at once, exactly.
template <int BT>
__device__ __forceinline__ bool count_row(const uint32_t* __restrict__ row,
                                          const uint32_t* s_nlit, int W,
                                          int lane, int (&viol)[BT]) {
#pragma unroll
  for (int b = 0; b < BT; ++b) viol[b] = 0;
  uint32_t any = 0;
#pragma unroll 4
  for (int w = lane; w < W; w += 32) {
    const uint32_t x = __ldg(row + w);
    any |= x;
#pragma unroll
    for (int b = 0; b < BT; ++b) viol[b] += __popc(x & s_nlit[b * W + w]);
  }
#pragma unroll
  for (int b = 0; b < BT; ++b)
    viol[b] = __reduce_add_sync(0xffffffffu, viol[b]);
  return __any_sync(0xffffffffu, any != 0u);
}

template <int BT>
__global__ void __launch_bounds__(kWarps * 32)
clause_outputs_kernel(const uint32_t* __restrict__ inc,   // (NB, CM, W)
                      const uint32_t* __restrict__ nlit,  // (NB, B, W)
                      int32_t* __restrict__ fired,        // (NB, B, CM)
                      int CM, int W, int B, int predict) {
  extern __shared__ uint32_t s_rows[];                  // (BT, W)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + warp;
  const int b0 = blockIdx.y * BT;
  const size_t n = blockIdx.z;
  const int nb = min(BT, B - b0);

  stage_rows<BT>(s_rows, nlit + (n * B + b0) * W, nb, W);
  __syncthreads();
  if (j >= CM) return;                 // the whole warp leaves together

  int viol[BT];
  const bool nonempty = count_row<BT>(inc + (n * CM + j) * (size_t)W, s_rows,
                                      W, lane, viol);
  const bool silent = predict && !nonempty;
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    if (lane == b && b < nb)
      fired[(n * B + b0 + b) * CM + j] = (!silent && viol[b] == 0) ? 1 : 0;
  }
}

// Launch `kernel` with BT-row sample tiles staged in dynamic shared memory
// (above 48 KB only after the kernel's opt-in).
template <typename K, typename... Args>
cudaError_t launch(K kernel, int bt, dim3 grid, int W, void* stream,
                   Args... args) {
  const size_t smem = sizeof(uint32_t) * bt * (size_t)W;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// inc: (N,C,m,L) bytes, lits: (N,B,L) int32, wpol: int32 at strides
// (sN, sC, sJ) elements, votes: (N,B,C) int32, written once.  The launch
// is planned by plan_votes (votes_plan.h).  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int fused_votes_batched(const void* inc, const void* lits,
                                   const void* wpol, void* votes, int N,
                                   int C, int m, int L, int B, long long sN,
                                   long long sC, long long sJ, int predict,
                                   void* stream) {
  return (int)launch_votes(inc, lits, wpol, votes, N, C, m, L, B, sN, sC, sJ,
                           predict, stream);
}

// One model: inc (C,m,L), lits (B,L), wpol at strides (sC, sJ), votes
// (B,C): the kernel above with N = 1.
extern "C" int fused_votes(const void* inc, const void* lits,
                           const void* wpol, void* votes, int C, int m,
                           int L, int B, long long sC, long long sJ,
                           int predict, void* stream) {
  return (int)launch_votes(inc, lits, wpol, votes, 1, C, m, L, B, 0, sC, sJ,
                           predict, stream);
}

// inc: (NB,CM,W) words, nlit: (NB,B,W) words, fired: (NB,B,CM) int32.
// Sample tiles of 1 when B == 1 (the training scan), else of kBT.
extern "C" int clause_outputs(const void* inc, const void* nlit, void* fired,
                              int NB, int CM, int W, int B, int predict,
                              void* stream) {
  if (NB == 0 || B == 0 || CM == 0) return (int)cudaGetLastError();
  const auto* i32 = static_cast<const uint32_t*>(inc);
  const auto* n32 = static_cast<const uint32_t*>(nlit);
  auto* out = static_cast<int32_t*>(fired);
  const int bt = B == 1 ? 1 : kBT;
  const dim3 grid((CM + kWarps - 1) / kWarps, (B + bt - 1) / bt, NB);
  return (int)(bt == 1
      ? launch(clause_outputs_kernel<1>, 1, grid, W, stream, i32, n32, out,
               CM, W, B, predict)
      : launch(clause_outputs_kernel<kBT>, kBT, grid, W, stream, i32, n32,
               out, CM, W, B, predict));
}
