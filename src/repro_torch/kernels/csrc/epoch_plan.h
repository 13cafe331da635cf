// The shape of train_epoch_kernel (train_epoch.cu) and its launch plan:
// plain C++, so the plan is built and tested on a host without CUDA too
// (tests/test_torch_epoch.py compiles this file with the host compiler).
//
// A client's epoch runs on a cluster of K blocks.  Block rank r owns the
// contiguous clauses [clause_begin(m, K, r), clause_begin(m, K, r + 1)) of
// every class and keeps their include bits (one bit per literal, 32 to a
// word) and weights in shared memory for the whole epoch.
//
// Two plans.  The shared plan keeps the include bits in shared memory; it
// is the plan of every shape whose bits fit the shared memory of at most
// kmax blocks.  Where they do not (62 classes of 300 clauses at L = 1568:
// 3,645,600 B a client, beyond 16 x 232,448 B), the global plan keeps
// them in device memory instead, (N, C, m, W) words that stay in L2 while
// a step reads them: a step reads only its class's rows, and a block only
// the rows it owns, so each word has one reader and one writer, the block
// that owns it.  Shared memory then holds the weights and the staged
// samples alone.
#pragma once

#include <algorithm>
#include <cstdint>

#include "threefry.h"

#ifdef __CUDACC__
#define EPOCH_HD __host__ __device__ __forceinline__
#else
#define EPOCH_HD inline
#endif

namespace epoch_layout {

constexpr int kWarps = 16;                // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kStageSamples = 16;         // samples staged at once
constexpr int kItemWords = 4;             // include words per TA-pass item
constexpr int kLoadWords = 8;             // words a warp loads at once
constexpr int kPortableCluster = 8;       // blocks per cluster, portable
constexpr int kMaxCluster = 16;           // with the non-portable opt-in
constexpr int kSmemBlock = 232448;        // shared memory a block may use
constexpr int kKeyWords = 2 * 3 * 2;      // a sample's role keys: 2 x 3 x 2

// Include words of a row of L literals.
EPOCH_HD int words(int L) { return (int)(((long long)L + 31) / 32); }

// The first clause of rank r of K (r = K gives m): contiguous ranges whose
// sizes differ by at most one.
EPOCH_HD int clause_begin(int m, int K, int r) {
  return (int)((long long)m * r / K);
}

// The most clauses a rank owns: the rows of each class in shared memory.
EPOCH_HD int owned_max(int m, int K) { return (m + K - 1) / K; }

// Byte offsets of the block's shared memory, each 16-byte aligned.
struct Layout {
  int inc;     // (C, owned, W) uint32 include words (none: global plan)
  int w;       // (C, owned) int32 weights
  int lit;     // (kStageSamples, W) uint32 literal words
  int keys;    // (kStageSamples, kKeyWords) uint32 role-key words
  int cls;     // (kStageSamples, 2) int32 target and negative class
  int rows;    // (owned,) int32 rows the TA pass updates this step
  int fired;   // (owned,) uint8 clause outputs of this step
  int vote;    // (2, kMaxCluster) int32 the cluster's partial votes
  int red;     // (kWarps,) int32 the warps' partial votes
  int nrows;   // int32 count of rows
  int bytes;   // the whole
};

// x, or 2**30 where x is larger (sizes far beyond shared memory).
EPOCH_HD int capped(long long x) {
  return x < (1LL << 30) ? (int)x : 1 << 30;
}

// Places regions one after the other, each 16-byte aligned.
struct Placer {
  long long at = 0;
  EPOCH_HD int take(long long bytes) {
    const long long here = at;
    at = (at + bytes + 15) / 16 * 16;
    return capped(here);
  }
};

EPOCH_HD Layout layout(int C, int owned, int W, bool inc_global = false) {
  Placer p;
  Layout a;
  a.inc = p.take(inc_global ? 0 : (long long)C * owned * W * 4);
  a.w = p.take((long long)C * owned * 4);
  a.lit = p.take((long long)kStageSamples * W * 4);
  a.keys = p.take(kStageSamples * kKeyWords * 4);
  a.cls = p.take(kStageSamples * 2 * 4);
  a.rows = p.take((long long)owned * 4);
  a.fired = p.take(owned);
  a.vote = p.take(2 * kMaxCluster * 4);
  a.red = p.take(kWarps * 4);
  a.nrows = p.take(4);
  a.bytes = capped(p.at);
  return a;
}

// Shared memory of a block of a K-block cluster.
inline long long smem_bytes(int C, int m, int L, int K,
                            bool inc_global = false) {
  return layout(C, owned_max(m, K), words(L), inc_global).bytes;
}

// The most blocks a client's cluster may take: no more than its clauses
// (every rank owns one at least), nor than kmax.
inline int cluster_cap(int m, int kmax) {
  return std::max(1, std::min(kmax, m));
}

// The smallest cluster whose blocks hold their shared memory (with the
// include bits unless inc_global), or 0 where even cluster_cap(m, kmax)
// blocks cannot.
inline int smallest_cluster(int C, int m, int L, int kmax,
                            bool inc_global = false) {
  for (int K = 1; K <= cluster_cap(m, kmax); ++K)
    if (smem_bytes(C, m, L, K, inc_global) <= kSmemBlock) return K;
  return 0;
}

// Whether (C, m, L) takes the global plan on a card whose clusters take at
// most kmax blocks: where no cluster holds the include bits in shared
// memory.  force takes it for any shape (to hold and time it against the
// shared plan).
inline bool takes_global(int C, int m, int L, int kmax, bool force) {
  return force || smallest_cluster(C, m, L, kmax) == 0;
}

// How train_epoch_kernel covers one epoch of N clients.
struct EpochPlan {
  int cluster;   // K: blocks per client, one cluster; the grid is (K, N)
  int owned;     // the most clauses a block owns
  int smem;      // dynamic shared memory a block, bytes
  int waves;     // rounds of N clusters the card takes: ceil(N / fit[K])
  int smallest;  // the smallest K that holds the include bits (global
                 // plan: that holds the weights and staged samples)
  int inc_global;  // 1: the include bits lie in device memory
};

// The plan of an epoch over N clients of C classes x m clauses x L
// literals.  fit[K] (K = 1 .. kmax) is how many clusters of K blocks, each
// with smem_bytes(C, m, L, K, inc_global), the card runs at once (entries
// below smallest_cluster are not read).  K is the largest that runs all N
// clusters in one wave, from the smallest that holds the block's shared
// memory up to cluster_cap(m, kmax); where none does, the smallest.
// Returns false for a shape the kernel cannot hold: shared memory that
// needs more than kmax blocks (with the include bits, on the shared plan),
// coin counters of 2**31 or more (m * L), a client's include words of
// 2**31 or more (global plan), or a card that runs no such cluster at all.
// The shared plan (inc_global false) is the launcher's where
// takes_global() is false.
inline bool plan_epoch(int N, int C, int m, int L, int kmax, const int* fit,
                       EpochPlan* p, bool inc_global = false) {
  if (N < 1 || C < 1 || m < 0 || L < 0 || kmax < 1 || kmax > kMaxCluster)
    return false;
  if (!threefry::counters_fit(m, L)) return false;
  if (inc_global && (long long)C * m * words(L) >= (1LL << 31)) return false;
  const int smallest = smallest_cluster(C, m, L, kmax, inc_global);
  if (smallest == 0 || fit[smallest] < 1) return false;
  int K = smallest;
  for (int k = cluster_cap(m, kmax); k > smallest; --k) {
    if (fit[k] >= N) {
      K = k;
      break;
    }
  }
  p->cluster = K;
  p->owned = owned_max(m, K);
  p->smem = (int)smem_bytes(C, m, L, K, inc_global);
  p->waves = (N + fit[K] - 1) / fit[K];
  p->smallest = smallest;
  p->inc_global = inc_global;
  return true;
}

}  // namespace epoch_layout
