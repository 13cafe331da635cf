// One sample step's Type I / Type II Tsetlin-automaton transitions, both
// feedback roles of every client, in place, for sm_90a, drawing its own
// randomness.
//
// Replaces src/repro/kernels/ta_update.py::ta_update_pallas (body
// _ta_kernel) together with the draws its caller makes for it
// (src/repro/core/tm.py::_feedback_one_class): for each client n and role
// r (0 target, 1 negative) on the class bank c = cls2[n, r] of ta
// (N, C, m, L) int32 in [1, 2N], with role keys [k_act, k_s1, k_s2],
//   v       = clamp(votes[n, c], -T, T)
//   active  = uniform(k_act)[j] < (T -/+ v) * f32(1/2T)
//   type1   = active & (clause j's polarity is the role's: even j for the
//             target, odd for the negative); type2 = active & !type1
//   Type I  : +1 where fired & lit with probability p_inc (uniform(k_s1)),
//             -1 elsewhere with probability p_dec (uniform(k_s2))
//   Type II : +1 where fired & !lit & ta <= N
//   then the clamp to [1, 2N].
// The reference draws the two (m, L) uniform planes of each role; threefry
// is counter-based, so this kernel hashes only the draw the update reads,
// through threefry::coin (counter j*L + l under k_s1 where the literal is
// hit, under k_s2 where not), compared in integers with
// draws.int_threshold.  The one float operation is the one XLA compiles the
// reference's "/ (2T)" to: a multiply by the correctly rounded f32
// reciprocal of 2T, formed with an IEEE divide (no fast math).  Both roles
// read the clause outputs and votes from before either update, and touch
// different banks (the caller refuses cls2[n, 0] == cls2[n, 1]), so one
// launch updates both in place.
//
// What bounds it on an H100: integer instructions.  A Type I row hashes
// one threefry-2x32 per literal (about 62 ALU-pipe instructions a coin,
// chip_smoke.py counts them from cuobjdump -sass), a Type II row hashes
// nothing, a row without feedback is neither read nor written.  At the
// paper's width (20 clients, m = 300, L = 1568) a step has some hundreds to
// a few thousand Type I rows: their hashing outweighs their bytes (12.5 KB
// a row read and written) about two to one.
//
// Design: one cooperative launch of a persistent grid (as many blocks as
// the card holds at once), in two phases split by one grid barrier.
// 1. Every block packs a share of the literal rows into bits (one ballot a
//    word), draws the activation of a contiguous share of the N * 2 * m
//    (client, role, clause) rows and lists, in order, the rows that take
//    feedback (Type I, or Type II on a fired clause) in device scratch,
//    each with what its items need (bank row, flags, coin keys: 32 bytes).
// 2. After the barrier every block copies the literal bits into shared
//    memory and scans the blocks' list lengths; the warps of the grid then
//    take (listed row, 256 literals) items in turn, so the hashing is spread
//    by hashing rows, not by rows.  A lane reads and writes four
//    consecutive states a 128-bit access (coalesced along L) where L is a
//    multiple of 4, else one state a 32-bit access; a Type I item hashes
//    its eight coins a lane in registers.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "threefry.h"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 2;                  // 128-literal passes an item
constexpr int kItemLits = 128 * kVecs;    // literals a warp item covers
constexpr int kMaxGrid = 2048;            // blocks of one launch, at most
constexpr int kMaxSmem = 232448;          // a block's shared memory, bytes
constexpr int kNoPlan = -1;               // a shape the kernel cannot take

struct Args {
  int32_t* ta;               // (N, C, m, L), updated in place
  const int32_t* lits;       // (N, L), rows lit_stride apart
  const int32_t* fired;      // (N, C, m)
  const int32_t* votes;      // (N, C)
  const int32_t* cls2;       // (N, 2), rows cls_stride apart
  const uint32_t* keys;      // (N, 2, 3, 2) int64, rows key_stride apart
  int4* rows;                // scratch: two int4 a listed row, N * 2 * m
  uint32_t* lit_bits;        // scratch: N * W literal words
  int32_t* counts;           // scratch: one list length a block
  long long lit_stride, cls_stride, key_stride;
  int N, C, m, L, n_states, T;
  uint32_t t_inc, t_dec;
};

// Row r = (n * 2 + role) * m + j of the step: whether it takes feedback
// (Type I, or Type II on a fired clause), and if so what its items need,
// as two int4: (bank row (n * C + c) * m + j, client n, bit 0 Type I and
// bit 1 fired, coin counter j * L) and the words of k_s1 and k_s2.
__device__ __forceinline__ bool feedback(const Args& a, int row, float inv,
                                         int4* d0, int4* d1) {
  const int nr = row / a.m, j = row - nr * a.m;
  const int n = nr >> 1, r = nr & 1;
  const int c = a.cls2[n * a.cls_stride + r];
  const int v = min(max(a.votes[n * a.C + c], -a.T), a.T);
  const float p_act = (float)(r == 0 ? a.T - v : a.T + v) * inv;
  // word w of key q (0 k_act, 1 k_s1, 2 k_s2) is k[4 * q + 2 * w]: the
  // low half of an int64 (little-endian)
  const uint32_t* k = a.keys + 2 * (n * a.key_stride + r * 6);
  const bool active =
      threefry::uniform(threefry::bits(threefry::make_key(k[0], k[2]),
                                       (uint32_t)j)) < p_act;
  if (!active) return false;
  const bool type1 = ((j & 1) == 0) == (r == 0);
  const int bank_row = (n * a.C + c) * a.m + j;
  const bool fired = a.fired[bank_row] != 0;
  if (!type1 && !fired) return false;
  *d0 = make_int4(bank_row, n, (type1 ? 1 : 0) | (fired ? 2 : 0),
                  (int)threefry::coin_counter(j, 0, a.L));
  *d1 = make_int4((int)k[4], (int)k[6], (int)k[8], (int)k[10]);
  return true;
}

// One item: literals [l0, l0 + kItemLits) of a listed row.
template <bool kVec4>
__device__ __forceinline__ void update_item(
    int32_t* __restrict__ row, const uint32_t* __restrict__ lit, int L,
    int l0, bool type1, bool fired, uint32_t ctr0, threefry::Key k_s1,
    threefry::Key k_s2, uint32_t t_inc, uint32_t t_dec, int n_states,
    int lane) {
  constexpr int kPer = 4 * kVecs;         // states a lane
  int idx[kPer];
  int32_t s[kPer];
  bool on[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u)
    idx[u] = kVec4 ? l0 + (u >> 2) * 128 + 4 * lane + (u & 3)
                   : l0 + u * 32 + lane;
  if constexpr (kVec4) {
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const int l = idx[4 * v];
      const int4 x = l < L ? *reinterpret_cast<const int4*>(row + l)
                           : make_int4(0, 0, 0, 0);
      const uint32_t b = l < L ? lit[l >> 5] >> (l & 31) : 0u;
      s[4 * v] = x.x; s[4 * v + 1] = x.y; s[4 * v + 2] = x.z;
      s[4 * v + 3] = x.w;
#pragma unroll
      for (int e = 0; e < 4; ++e) on[4 * v + e] = (b >> e) & 1u;
    }
  } else {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int l = idx[u];
      s[u] = l < L ? row[l] : 0;
      on[u] = l < L && ((lit[l >> 5] >> (l & 31)) & 1u);
    }
  }
  const int two_n = 2 * n_states;
  int32_t out[kPer];
  if (type1) {   // every literal draws its coin
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const bool hit = fired && on[u];
      const bool c = threefry::coin(k_s1, k_s2, t_inc, t_dec,
                                    ctr0 + (uint32_t)idx[u], hit);
      const int d = c ? (hit ? 1 : -1) : 0;
      out[u] = min(max(s[u] + d, 1), two_n);
    }
  } else {       // Type II on a fired clause: excluded literals that are 0
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      out[u] = (!on[u] && s[u] <= n_states) ? min(s[u] + 1, two_n) : s[u];
  }
  if constexpr (kVec4) {
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const int l = idx[4 * v];
      if (l < L)
        *reinterpret_cast<int4*>(row + l) =
            make_int4(out[4 * v], out[4 * v + 1], out[4 * v + 2],
                      out[4 * v + 3]);
    }
  } else {
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if (idx[u] < L) row[idx[u]] = out[u];
  }
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
ta_update_kernel(Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int s_wsum[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int W = (a.L + 31) / 32;
  const int R = a.N * 2 * a.m;
  const int per_block = (R + G - 1) / G;

  // 1a. the literal rows as bits, one warp a word
  for (int wd = (int)blockIdx.x * kWarps + warp; wd < a.N * W;
       wd += G * kWarps) {
    const int n = wd / W, l = (wd - n * W) * 32 + lane;
    const bool on = l < a.L && a.lits[n * a.lit_stride + l] != 0;
    const uint32_t b = __ballot_sync(~0u, on);
    if (lane == 0) a.lit_bits[wd] = b;
  }
  // 1b. the block's rows that take feedback, listed in order
  const float inv = 1.0f / (float)(2 * a.T);   // IEEE divide: exact f32(1/2T)
  const int r0 = min((int)blockIdx.x * per_block, R);
  const int r1 = min(r0 + per_block, R);
  int listed = 0;                  // the same in every thread of the block
  for (int base = r0; base < r1; base += kThreads) {
    const int r = base + threadIdx.x;
    int4 d0, d1;
    const bool take = r < r1 && feedback(a, r, inv, &d0, &d1);
    const uint32_t mask = __ballot_sync(~0u, take);
    if (lane == 0) s_wsum[warp] = __popc(mask);
    __syncthreads();
    int before = listed, sum = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += s_wsum[w];
      sum += s_wsum[w];
    }
    if (take) {
      int4* d = a.rows + 2 * (r0 + before +
                              __popc(mask & ((1u << lane) - 1u)));
      d[0] = d0;
      d[1] = d1;
    }
    listed += sum;
    __syncthreads();             // s_wsum is written again next pass
  }
  if (threadIdx.x == 0) a.counts[blockIdx.x] = listed;
  grid.sync();

  // 2. the literal bits and the lists' offsets into shared memory
  uint32_t* s_lit = smem;                                   // N * W
  int* s_pre = reinterpret_cast<int*>(smem + a.N * W);      // G + 1
  for (int i = threadIdx.x; i < a.N * W; i += kThreads)
    s_lit[i] = a.lit_bits[i];
  for (int b = threadIdx.x; b < G; b += kThreads) s_pre[b + 1] = a.counts[b];
  __syncthreads();
  if (warp == 0) {
    int run = 0;
    for (int b0 = 0; b0 < G; b0 += 32) {
      int c = b0 + lane < G ? s_pre[b0 + lane + 1] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(~0u, c, d);
        if (lane >= d) c += t;
      }
      if (b0 + lane < G) s_pre[b0 + lane + 1] = run + c;
      run += __shfl_sync(~0u, c, 31);
    }
    if (lane == 0) s_pre[0] = 0;
  }
  __syncthreads();

  const int chunks = (a.L + kItemLits - 1) / kItemLits;
  const long long items = (long long)s_pre[G] * chunks;
  for (long long it = (long long)warp * G + blockIdx.x; it < items;
       it += (long long)G * kWarps) {
    const int idx = (int)(it / chunks);
    const int ch = (int)(it - (long long)idx * chunks);
    int lo = 0, hi = G;          // the block whose list holds entry idx
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (s_pre[mid] <= idx) lo = mid; else hi = mid;
    }
    const int4* d = a.rows + 2 * (lo * per_block + idx - s_pre[lo]);
    const int4 d0 = d[0], d1 = d[1];
    update_item<kVec4>(a.ta + (size_t)d0.x * a.L, s_lit + d0.y * W, a.L,
                       ch * kItemLits, (d0.z & 1) != 0, (d0.z & 2) != 0,
                       (uint32_t)d0.w,
                       threefry::make_key((uint32_t)d1.x, (uint32_t)d1.y),
                       threefry::make_key((uint32_t)d1.z, (uint32_t)d1.w),
                       a.t_inc, a.t_dec, a.n_states, lane);
  }
}

// The card's share of blocks for one instantiation at `smem` bytes of
// dynamic shared memory: blocks an SM holds at once, and the SMs.  Kept for
// the last shared-memory size of each device, under a lock.
template <bool kVec4>
cudaError_t residency(int smem, int* per_sm, int* sms) {
  static std::mutex lock;
  static int seen_smem[64] = {}, seen_per_sm[64] = {}, seen_sms[64] = {};
  static int attr_smem[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(lock);
  if (seen_per_sm[dev] == 0 || seen_smem[dev] != smem) {
    if (smem > 48 * 1024 && smem > attr_smem[dev]) {
      e = cudaFuncSetAttribute(ta_update_kernel<kVec4>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e != cudaSuccess) return e;
      attr_smem[dev] = smem;
    }
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &seen_per_sm[dev], ta_update_kernel<kVec4>, kThreads, smem);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&seen_sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
    seen_smem[dev] = smem;
  }
  *per_sm = seen_per_sm[dev];
  *sms = seen_sms[dev];
  return cudaSuccess;
}

struct Plan {
  int grid, smem, vec4;
};

// The launch of (N, C, m, L) with `scratch_words` int32 words of scratch
// on the current device; false for a shape the kernel cannot take.
cudaError_t plan(int N, int C, int m, int L, long long scratch_words,
                 bool vec4, Plan* p, bool* ok) {
  *ok = false;
  const long long R = 2LL * N * m;
  const long long W = (L + 31) / 32;
  if (N <= 0 || C < 2 || m <= 0 || L <= 0 ||
      !threefry::counters_fit(m, L) || (long long)N * C * m >= (1LL << 31))
    return cudaSuccess;
  const long long smem = 4 * (N * W + kMaxGrid + 1);
  const long long g_scratch = scratch_words - 8 * R - N * W;
  if (smem > kMaxSmem || g_scratch < 1) return cudaSuccess;
  int per_sm = 0, sms = 0;
  const cudaError_t e = vec4 ? residency<true>((int)smem, &per_sm, &sms)
                             : residency<false>((int)smem, &per_sm, &sms);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaSuccess;
  const long long chunks = (L + kItemLits - 1) / kItemLits;
  long long g = (long long)per_sm * sms;
  g = g < kMaxGrid ? g : kMaxGrid;
  g = g < g_scratch ? g : g_scratch;
  const long long work = (R * chunks + kWarps - 1) / kWarps;
  g = g < work ? g : work;
  p->grid = (int)(g > 0 ? g : 1);
  p->smem = (int)smem;
  p->vec4 = vec4;
  *ok = true;
  return cudaSuccess;
}

}  // namespace

// The launch plan of one step on the current device, for tests and
// reports: out = (blocks, dynamic shared memory a block, 128-bit row
// accesses or not).  Launches nothing; returns -1 for a shape the kernel
// cannot take, else a CUDA error code.
extern "C" int ta_update_plan(int N, int C, int m, int L,
                              long long scratch_words, int vec4, int* out) {
  Plan p;
  bool ok = false;
  const cudaError_t e = plan(N, C, m, L, scratch_words, vec4 != 0, &p, &ok);
  if (e != cudaSuccess) return (int)e;
  if (!ok) return kNoPlan;
  out[0] = p.grid;
  out[1] = p.smem;
  out[2] = p.vec4;
  return 0;
}

// One sample step in place on ta (N, C, m, L) int32, contiguous.  lits
// (N, L) int32 0/1, cls2 (N, 2) int32 and keys (N, 2, 3, 2) int64 (uint32
// words, draws.epoch_keys' role keys of the step) have contiguous rows
// lit_stride / cls_stride / key_stride elements apart; fired (N, C, m) and
// votes (N, C) int32 contiguous; scratch holds scratch_words int32 words,
// 16-byte aligned (8 * 2 * N * m + N * ceil(L / 32) and one a block).  t_inc and t_dec are
// draws.int_threshold(p_inc / p_dec).  Launches on `stream`; returns -1 for
// a shape it cannot take, else cudaGetLastError().
extern "C" int ta_update(void* ta, const void* lits, const void* fired,
                         const void* votes, const void* cls2,
                         const void* keys, void* scratch, int N, int C,
                         int m, int L, long long lit_stride,
                         long long cls_stride, long long key_stride,
                         long long scratch_words, int n_states, int T,
                         int t_inc, int t_dec, void* stream) {
  if (N == 0) return (int)cudaGetLastError();
  const bool vec4 = L % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(ta) % 16 == 0;
  Plan p;
  bool ok = false;
  const cudaError_t e = plan(N, C, m, L, scratch_words, vec4, &p, &ok);
  if (e != cudaSuccess) return (int)e;
  if (!ok) return kNoPlan;
  const long long R = 2LL * N * m;
  Args a;
  a.ta = static_cast<int32_t*>(ta);
  a.lits = static_cast<const int32_t*>(lits);
  a.fired = static_cast<const int32_t*>(fired);
  a.votes = static_cast<const int32_t*>(votes);
  a.cls2 = static_cast<const int32_t*>(cls2);
  a.keys = static_cast<const uint32_t*>(keys);
  a.rows = static_cast<int4*>(scratch);
  a.lit_bits = reinterpret_cast<uint32_t*>(a.rows + 2 * R);
  a.counts = reinterpret_cast<int32_t*>(a.lit_bits +
                                        (long long)N * ((L + 31) / 32));
  a.lit_stride = lit_stride;
  a.cls_stride = cls_stride;
  a.key_stride = key_stride;
  a.N = N;
  a.C = C;
  a.m = m;
  a.L = L;
  a.n_states = n_states;
  a.T = T;
  a.t_inc = (uint32_t)t_inc;
  a.t_dec = (uint32_t)t_dec;
  void* params[] = {&a};
  const void* fn = vec4 ? (const void*)ta_update_kernel<true>
                        : (const void*)ta_update_kernel<false>;
  const cudaError_t le = cudaLaunchCooperativeKernel(
      fn, dim3(p.grid), dim3(kThreads), params, (size_t)p.smem,
      (cudaStream_t)stream);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}
