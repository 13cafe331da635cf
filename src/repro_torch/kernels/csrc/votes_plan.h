// The shape of votes_mma_kernel (clause_eval.cu) and its launch plan:
// plain C++, so the plan is built and tested on a host without CUDA too
// (tests/test_torch_kernels.py compiles this file on its own).
#pragma once

#include <algorithm>
#include <cstdint>

#ifdef __CUDACC__
#define VOTES_HD __host__ __device__
#else
#define VOTES_HD
#endif

namespace vote_layout {

constexpr int kWarps = 8;            // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 64;           // literals per row per ring stage
constexpr int kStageBytes = 16 * kChunk;   // one stage: 16 rows of a chunk
constexpr int kMinStages = 2;
constexpr int kMaxStages = 16;
constexpr int kMaxPass = 128;        // samples per pass at most (16 n-tiles)
constexpr int kMaxCluster = 8;       // blocks per cluster: the portable most
constexpr int kSmemBlock = 232448;   // dynamic + static a block may use
constexpr int kSmemTwo = 233472 / 2 - 1024;   // each of two blocks an SM

// The kernel's static shared memory.
struct VoteShared {
  int32_t vote[kWarps][kMaxPass];      // a warp's sums per sample
  uint32_t any[kWarps][2][32];         // the K parts' empty-clause words
  int32_t part[kMaxCluster][kMaxPass]; // the cluster's block sums (rank 0's)
  uint64_t bar[kWarps][kMaxStages];    // the rings' mbarriers
};

// Bytes of one staged sample row of (1 - lit): a multiple of 128 plus 64,
// so the 8 lanes of a 16-byte shared load phase (two samples) hit every
// bank once.
VOTES_HD constexpr int row_stride(int L) {
  return (L + 127) / 128 * 128 + 64;
}

// Partial counts of the K parts, (kWarps, NT, 4, 32) int32, when ks > 1.
VOTES_HD constexpr int count_bytes(int nt) {
  return kWarps * nt * 4 * 32 * 4;
}

// How votes_mma_kernel covers one call.
struct VotePlan {
  int cluster;   // blocks per (client, class), splitting its 16-row tiles
  int ks;        // warps of a block splitting one tile's chunks
  int pass;      // samples staged per pass (all B when they fit)
  int nt;        // n-tiles of 8 samples: the instantiation that holds pass
  int stages;    // ring stages a warp
  int smem;      // dynamic shared memory, bytes
};

inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// The plan of a call on a card with `sms` SMs:
// * the cluster doubles, up to kMaxCluster and the class's tile count,
//   while the N*C clusters leave SMs without a block;
// * a pass holds all B samples, rounded up to 8, when they fit in shared
//   memory beside the smallest ring and kMaxPass; else as many as fit;
// * ks: the block's warps over its largest tile count (a power of two, no
//   more than the chunks), when their partial counts also fit;
// * stages: as many as fit one block an SM when the grid has no more
//   blocks than SMs; else as many as keep two blocks an SM where the
//   smallest ring does (up to 8 n-tiles), else as many as fit one block.
// Returns false for a shape the kernel cannot hold.
inline bool plan_votes(int N, int C, int m, int L, int B, int sms,
                       VotePlan* p) {
  if (N < 1 || C < 1 || B < 1 || m < 0 || L < 0 || sms < 1) return false;
  const int statics = (int)sizeof(VoteShared);
  const int tiles = (m + 15) / 16;
  const int chunks = (L + kChunk - 1) / kChunk;
  const int stride = row_stride(L);
  const int ring = kWarps * kStageBytes;         // a block's bytes a stage
  const int room = kSmemBlock - statics;
  const int fit = (room - kMinStages * ring) / stride / 8 * 8;
  if (fit < 8) return false;
  p->pass = std::min({(B + 7) / 8 * 8, kMaxPass, fit});
  p->nt = pow2_at_least(p->pass / 8);
  p->cluster = 1;
  while ((long long)N * C * p->cluster < sms &&
         2 * p->cluster <= std::min(kMaxCluster, tiles))
    p->cluster *= 2;
  const int per_block = (tiles + p->cluster - 1) / p->cluster;
  p->ks = std::max(1, kWarps / pow2_at_least(per_block));
  p->ks = std::min(p->ks, pow2_at_least(chunks));
  const int base = p->pass * stride;
  if (p->ks > 1 && base + count_bytes(p->nt) + kMinStages * ring > room)
    p->ks = 1;
  const int fixed = base + (p->ks > 1 ? count_bytes(p->nt) : 0);
  const int two = kSmemTwo - statics;
  const bool one_wave = (long long)N * C * p->cluster <= sms;
  const int cap = !one_wave && p->nt <= 8 && fixed + kMinStages * ring <= two
                      ? two : room;
  p->stages = std::min(kMaxStages, (cap - fixed) / ring);
  p->smem = fixed + p->stages * ring;
  return true;
}

}  // namespace vote_layout

// The plan of a vote call on a card with `sms` SMs, for tests and
// reports: out = (cluster, ks, pass, nt, stages, dynamic shared memory,
// static shared memory).  Touches no device; returns 1 for a shape the
// kernel cannot hold.
extern "C" int votes_plan(int N, int C, int m, int L, int B, int sms,
                          int* out) {
  vote_layout::VotePlan p;
  if (!vote_layout::plan_votes(N, C, m, L, B, sms, &p)) return 1;
  const int v[7] = {p.cluster, p.ks,   p.pass, p.nt,
                    p.stages,  p.smem, (int)sizeof(vote_layout::VoteShared)};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}
