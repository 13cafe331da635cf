// One fused Tsetlin-Machine training epoch over N stacked clients, for
// sm_90a, drawing its own randomness.
//
// Replaces src/repro/kernels/train_epoch.py::train_epoch_pallas (body
// _epoch_kernel) together with its input contract,
// src/repro/kernels/draws.py::epoch_draws.  For each client, a loop of 2*S
// steps over (sample s, role r in {target, negative}) on the class bank
// cls2[n,s,r]:
//   1. clause outputs on the sample's literals (empty clauses fire);
//   2. the Eq.-1 vote sum_j fired_j * pol_j * w_j, clipped to [-T, T];
//   3. activation u_act < (T -/+ v) * f32(1/2T) and the Type I / Type II
//      choice per clause (Type I on same-polarity clauses of the target,
//      opposite-polarity of the negative; Type II the complement);
//   4. the TA transition, clamped to [1, 2*n_states], and the weight
//      update floored at 0.
// The reference draws the epoch's randomness before the kernel: per
// (sample, role) keys [k_act, k_s1, k_s2], activation uniforms from k_act
// and a plane of coins, (N, S, 2, m, L), from k_s1 (increment) and k_s2
// (decrement).  Threefry is counter-based, so this kernel takes the keys
// and hashes only what it reads (threefry.h): u_act of clause j is
// uniform(bits(k_act, j)); a Type I row j hashes, for each literal l, the
// one coin its update reads, counter j*L + l under k_s1 where the literal
// is hit and under k_s2 where it is not.  The result is bit-identical to
// the Pallas kernel fed by epoch_draws: every count is an exact integer,
// and the one float operation is the one XLA compiles the reference's
// "/ (2T)" to: a multiply by the correctly rounded f32 reciprocal of 2T,
// formed here with an IEEE divide (no fast math).
//
// What bounds it on an H100: integer instructions.  Each (Type I row,
// literal) is one threefry-2x32; the TA pass issues about 86 instructions
// a coin, about 62 of them on the ALU pipe (rotations, XORs, three-input
// adds, key selects) and 20 on the FMA pipe (the adds ptxas moves there
// as IMAD.IADD), as chip_smoke.py counts them from cuobjdump -sass.  The
// ALU pipe's 64 lanes an SM set the bound: at the paper's width (20
// clients, S = 80, C = 10, m = 300, L = 1568) about 10^5 Type I rows an
// epoch make that near 0.7 ms on the 132 SMs, against about 0.23 ms for
// the bytes (the banks read once and written once).  The design keeps
// everything else off that path: no coin plane, the include bits of every
// owned clause in shared memory (the banks are read once, not once a
// step), and the clauses of a client spread over a cluster so the hashing
// fills the SMs.
//
// Design: a cluster of K blocks per client, grid (K, N); epoch_plan.h
// picks K to fill the card in one wave (K = 1 where the clients alone
// do).  Block rank r owns a contiguous range of every class's clauses;
// polarity is that of the global clause index.
// * Prologue: read the owned TA rows once, write them to the output, and
//   keep their include bits (one ballot per 32 literals) and weights in
//   shared memory.  One cluster barrier, so every block runs before any
//   writes into its shared memory.
// * Every 16 samples: stage their literal bits, classes and keys.
// * Per step: clause outputs as an AND-NOT over the include words; the
//   block's partial vote is written into every rank's shared memory
//   (DSMEM), in a slot of the step's parity, so one cluster barrier a step
//   suffices (a rank writes a slot again only two steps later, after every
//   rank has passed the barrier that follows its last read of it); every
//   rank adds the K partials in rank order to the same clipped vote; one
//   thread a clause draws its activation, picks the feedback type, updates
//   its weight in shared memory and lists the row if it changes.
// * The TA pass spreads (row, 128 literals) items over the warps: a lane
//   takes four literals, 32 apart, so loads and stores are coalesced and
//   each ballot is one include word; Type I rows hash the four coins in
//   registers, fired Type II rows need none; changed states are written
//   back to device memory (in place in the output) and the include words
//   rebuilt from the new states.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "epoch_plan.h"
#include "threefry.h"

namespace cg = cooperative_groups;
using namespace epoch_layout;

namespace {

constexpr int kNoPlan = -1;   // returned for a shape with no launch plan

__global__ void __launch_bounds__(kThreads, 1)
train_epoch_kernel(int32_t* __restrict__ ta_out,        // (N, C, m, L)
                   int32_t* __restrict__ w_out,         // (N, C, m)
                   const int32_t* __restrict__ ta,      // (N, C, m, L)
                   const int32_t* __restrict__ w,       // (N, C, m)
                   const int32_t* __restrict__ lits,    // (N, S, L)
                   const int32_t* __restrict__ cls2,    // (N, S, 2)
                   const uint32_t* __restrict__ keys,   // (N, S, 12) int64
                   int C, int m, int L, int S, int n_states, int T,
                   uint32_t t_inc, uint32_t t_dec) {
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n = blockIdx.y;
  const int W = words(L);
  const int j0 = clause_begin(m, K, rank);
  const int mk = clause_begin(m, K, rank + 1) - j0;
  const int owned = owned_max(m, K);
  const Layout lay = layout(C, owned, W);
  uint32_t* s_inc = reinterpret_cast<uint32_t*>(smem + lay.inc);
  int32_t* s_w = reinterpret_cast<int32_t*>(smem + lay.w);
  uint32_t* s_lit = reinterpret_cast<uint32_t*>(smem + lay.lit);
  uint32_t* s_key = reinterpret_cast<uint32_t*>(smem + lay.keys);
  int32_t* s_cls = reinterpret_cast<int32_t*>(smem + lay.cls);
  int32_t* s_rows = reinterpret_cast<int32_t*>(smem + lay.rows);
  uint8_t* s_fired = smem + lay.fired;
  int32_t* s_vote = reinterpret_cast<int32_t*>(smem + lay.vote);
  int32_t* s_red = reinterpret_cast<int32_t*>(smem + lay.red);
  int32_t* s_nrows = reinterpret_cast<int32_t*>(smem + lay.nrows);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int two_n = 2 * n_states;

  // prologue: the owned rows of every class, kLoadWords words a warp at a
  // time (all loads in flight before the ballots)
  const int groups = (W + kLoadWords - 1) / kLoadWords;
  for (int item = warp; item < C * mk * groups; item += kWarps) {
    const int r = item / groups, g = item - r * groups;
    const int c = r / mk, jj = r - c * mk;
    const size_t base = (((size_t)n * C + c) * m + j0 + jj) * (size_t)L;
    int32_t v[kLoadWords];
#pragma unroll
    for (int u = 0; u < kLoadWords; ++u) {
      const int l = (g * kLoadWords + u) * 32 + lane;
      v[u] = l < L ? ta[base + l] : 0;
    }
#pragma unroll
    for (int u = 0; u < kLoadWords; ++u) {
      const int wd = g * kLoadWords + u;
      const int l = wd * 32 + lane;
      if (l < L) ta_out[base + l] = v[u];
      const uint32_t inc = __ballot_sync(~0u, l < L && v[u] > n_states);
      if (lane == 0 && wd < W) s_inc[(c * owned + jj) * W + wd] = inc;
    }
  }
  for (int i = threadIdx.x; i < C * mk; i += kThreads) {
    const int c = i / mk, jj = i - c * mk;
    s_w[c * owned + jj] = w[((size_t)n * C + c) * m + j0 + jj];
  }
  cluster.sync();

  // XLA's x / c for a constant c: x * f32(1/c), 1/c correctly rounded
  const float inv = 1.0f / (float)(2 * T);
  for (int step = 0; step < 2 * S; ++step) {
    const int s = step >> 1;
    const int role = step & 1;                 // 0 target, 1 negative
    const int q = s % kStageSamples;
    if (q == 0 && role == 0) {
      // stage samples [s, s + ns): literal words, classes, role keys
      const int ns = min(kStageSamples, S - s);
      const int32_t* lit0 = lits + ((size_t)n * S + s) * L;
      for (int item = warp; item < ns * groups; item += kWarps) {
        const int qq = item / groups, g = item - qq * groups;
        int32_t v[kLoadWords];
#pragma unroll
        for (int u = 0; u < kLoadWords; ++u) {
          const int l = (g * kLoadWords + u) * 32 + lane;
          v[u] = l < L ? lit0[(size_t)qq * L + l] : 0;
        }
#pragma unroll
        for (int u = 0; u < kLoadWords; ++u) {
          const int wd = g * kLoadWords + u;
          const uint32_t b = __ballot_sync(~0u, v[u] != 0);
          if (lane == 0 && wd < W) s_lit[qq * W + wd] = b;
        }
      }
      // each key word is the low half of an int64 (little-endian)
      const size_t k0 = ((size_t)n * S + s) * kKeyWords;
      for (int i = threadIdx.x; i < ns * kKeyWords; i += kThreads)
        s_key[i] = keys[2 * (k0 + i)];
      for (int i = threadIdx.x; i < ns * 2; i += kThreads)
        s_cls[i] = cls2[((size_t)n * S + s) * 2 + i];
      __syncthreads();
    }
    const int cls = s_cls[q * 2 + role];
    const uint32_t* litw = s_lit + q * W;
    const uint32_t* kw = s_key + q * kKeyWords + role * (kKeyWords / 2);
    uint32_t* inc_c = s_inc + cls * owned * W;
    int32_t* w_c = s_w + cls * owned;

    // 1. clause outputs in learning mode, and the block's partial vote
    int32_t part = 0;
    for (int jj = warp; jj < mk; jj += kWarps) {
      uint32_t viol = 0;
      for (int wd = lane; wd < W; wd += 32)
        viol |= inc_c[jj * W + wd] & ~litw[wd];
      const bool fired = !__any_sync(~0u, viol != 0);
      if (lane == 0) {
        s_fired[jj] = fired;
        if (fired) part += ((j0 + jj) & 1) ? -w_c[jj] : w_c[jj];
      }
    }
    if (lane == 0) s_red[warp] = part;
    __syncthreads();
    if (threadIdx.x == 0) {
      int32_t v = 0;
      for (int k = 0; k < kWarps; ++k) v += s_red[k];
      for (int k = 0; k < K; ++k)
        cluster.map_shared_rank(s_vote, k)[(step & 1) * kMaxCluster + rank] =
            v;
      *s_nrows = 0;
    }
    cluster.sync();

    // 2. the vote, activation, feedback type, the weight update, and the
    // rows the TA pass changes (Type I, and fired Type II)
    int32_t v = 0;
    for (int k = 0; k < K; ++k) v += s_vote[(step & 1) * kMaxCluster + k];
    v = min(max(v, -T), T);
    const float p_act = (float)(role == 0 ? T - v : T + v) * inv;
    const threefry::Key k_act = threefry::make_key(kw[0], kw[1]);
    for (int jj = threadIdx.x; jj < mk; jj += kThreads) {
      const int j = j0 + jj;
      const bool active =
          threefry::uniform(threefry::bits(k_act, (uint32_t)j)) < p_act;
      const bool same = ((j & 1) == 0) == (role == 0);
      const int fired = s_fired[jj];
      const int type1 = active && same;
      const int type2 = active && !same;
      w_c[jj] = max(w_c[jj] + (type1 & fired) - (type2 & fired), 0);
      if (type1 || (type2 && fired))
        s_rows[atomicAdd(s_nrows, 1)] = 2 * jj + type2;
    }
    __syncthreads();

    // 3. TA transitions, (row, 32 x kItemWords literals) a warp at a time
    const int nrows = *s_nrows;
    const int chunks = (W + kItemWords - 1) / kItemWords;
    const threefry::Key k_s1 = threefry::make_key(kw[2], kw[3]);
    const threefry::Key k_s2 = threefry::make_key(kw[4], kw[5]);
    for (int item = warp; item < nrows * chunks; item += kWarps) {
      const int r = item / chunks, ch = item - r * chunks;
      const int e = s_rows[r];
      const int jj = e >> 1;
      const int j = j0 + jj;
      const bool fired = s_fired[jj];
      int32_t* row = ta_out + (((size_t)n * C + cls) * m + j) * (size_t)L;
      int32_t a[kItemWords];
#pragma unroll
      for (int u = 0; u < kItemWords; ++u) {
        const int l = (ch * kItemWords + u) * 32 + lane;
        a[u] = l < L ? row[l] : 0;
      }
      int32_t b[kItemWords];
      if ((e & 1) == 0) {   // Type I: every literal draws its coin
#pragma unroll
        for (int u = 0; u < kItemWords; ++u) {
          const int wd = ch * kItemWords + u;
          const int l = wd * 32 + lane;
          const bool hit = fired && wd < W && ((litw[wd] >> lane) & 1u);
          const bool c = threefry::coin(k_s1, k_s2, t_inc, t_dec,
                                        threefry::coin_counter(j, l, L), hit);
          const int d = c ? (hit ? 1 : -1) : 0;
          b[u] = min(max(a[u] + d, 1), two_n);
        }
      } else {              // Type II, fired: excluded literals that are 0
#pragma unroll
        for (int u = 0; u < kItemWords; ++u) {
          const int wd = ch * kItemWords + u;
          const bool lit = wd < W && ((litw[wd] >> lane) & 1u);
          b[u] = (!lit && a[u] <= n_states) ? min(a[u] + 1, two_n) : a[u];
        }
      }
#pragma unroll
      for (int u = 0; u < kItemWords; ++u) {
        const int wd = ch * kItemWords + u;
        const int l = wd * 32 + lane;
        if (l < L && b[u] != a[u]) row[l] = b[u];
        const uint32_t inc = __ballot_sync(~0u, l < L && b[u] > n_states);
        if (lane == 0 && wd < W) inc_c[jj * W + wd] = inc;
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < C * mk; i += kThreads) {
    const int c = i / mk, jj = i - c * mk;
    w_out[((size_t)n * C + c) * m + j0 + jj] = s_w[c * owned + jj];
  }
}

// The device's clusters: how many of K blocks (K = 1 .. kMaxCluster) with
// the shared memory of (C, m, L) it runs at once (0 where K is not
// queried), and the most blocks a cluster may have there: 16 where the
// device grants the non-portable opt-in, else the portable 8.  The kernel's
// attributes are set to launch any of them.  Filled under a lock, so
// threads that plan or launch at once see whole entries; kept for the last
// few shapes of each device.
struct Fit {
  int dev = -1, C = 0, m = 0, L = 0, kmax = 0;
  int fit[kMaxCluster + 1] = {};
};

std::mutex fit_lock;

cudaError_t cluster_fit(int C, int m, int L, Fit* out) {
  static Fit cache[8];
  static int next = 0;
  static int smem_set[64] = {};
  static int kmax_of[64] = {};   // 0 until the opt-in was asked for
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(fit_lock);
  for (const Fit& f : cache) {
    if (f.dev == dev && f.C == C && f.m == m && f.L == L) {
      *out = f;
      return cudaSuccess;
    }
  }
  if (kmax_of[dev] == 0) {
    if (cudaFuncSetAttribute(train_epoch_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1) == cudaSuccess) {
      kmax_of[dev] = kMaxCluster;
    } else {
      cudaGetLastError();   // the opt-in is refused: portable sizes only
      kmax_of[dev] = kPortableCluster;
    }
  }
  Fit f;
  f.kmax = kmax_of[dev];
  const int smallest = smallest_cluster(C, m, L, f.kmax);
  for (int K = smallest > 0 ? smallest : f.kmax + 1;
       K <= cluster_cap(m, f.kmax); ++K) {
    const int smem = (int)smem_bytes(C, m, L, K);
    if (smem > smem_set[dev]) {
      e = cudaFuncSetAttribute(train_epoch_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e != cudaSuccess) return e;
      smem_set[dev] = smem;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(K, 1, 1);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = K;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int count = 0;
    if (cudaOccupancyMaxActiveClusters(&count, train_epoch_kernel, &cfg) !=
        cudaSuccess) {
      cudaGetLastError();   // a size the device refuses runs no cluster
      count = 0;
    }
    f.fit[K] = count;
  }
  f.dev = dev;
  f.C = C;
  f.m = m;
  f.L = L;
  cache[next] = f;
  next = (next + 1) % 8;
  *out = f;
  return cudaSuccess;
}

cudaError_t plan_on_device(int N, int C, int m, int L, EpochPlan* p,
                           int* kmax, bool* ok) {
  Fit f;
  const cudaError_t e = cluster_fit(C, m, L, &f);
  if (e != cudaSuccess) return e;
  *kmax = f.kmax;
  *ok = plan_epoch(N, C, m, L, f.kmax, f.fit, p);
  return cudaSuccess;
}

}  // namespace

// The plan of an epoch on the current device, for tests and reports:
// out = (cluster, owned clauses a block, dynamic shared memory, waves,
// smallest cluster, most blocks a cluster may take).  Launches nothing;
// returns -1 for a shape with no plan, else a CUDA error code.
extern "C" int train_epoch_plan(int N, int C, int m, int L, int* out) {
  EpochPlan p;
  int kmax = 0;
  bool ok = false;
  const cudaError_t e = plan_on_device(N, C, m, L, &p, &kmax, &ok);
  if (e != cudaSuccess) return (int)e;
  if (!ok) return kNoPlan;
  const int v[6] = {p.cluster, p.owned, p.smem, p.waves, p.smallest, kmax};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// One epoch: reads ta (N,C,m,L) and w (N,C,m), writes the trained banks
// and weights to ta_out and w_out (other tensors of the same shapes).
// keys (N,S,2,3,2) are int64 tensors of uint32 words (their low halves are
// read); t_inc and t_dec are draws.int_threshold(p_inc / p_dec).  Launches
// on `stream`; returns -1 for a shape with no plan, else
// cudaGetLastError().
extern "C" int train_epoch_fused(void* ta_out, void* w_out, const void* ta,
                                 const void* w, const void* lits,
                                 const void* cls2, const void* keys, int N,
                                 int C, int m, int L, int S, int n_states,
                                 int T, int t_inc, int t_dec, void* stream) {
  if (N == 0) return (int)cudaGetLastError();
  EpochPlan p;
  int kmax = 0;
  bool ok = false;
  const cudaError_t e = plan_on_device(N, C, m, L, &p, &kmax, &ok);
  if (e != cudaSuccess) return (int)e;
  if (!ok) return kNoPlan;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, N, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, train_epoch_kernel, static_cast<int32_t*>(ta_out),
                     static_cast<int32_t*>(w_out),
                     static_cast<const int32_t*>(ta),
                     static_cast<const int32_t*>(w),
                     static_cast<const int32_t*>(lits),
                     static_cast<const int32_t*>(cls2),
                     static_cast<const uint32_t*>(keys), C, m, L, S, n_states,
                     T, (uint32_t)t_inc, (uint32_t)t_dec);
  return (int)cudaGetLastError();
}
