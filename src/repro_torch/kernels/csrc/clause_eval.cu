// Clause evaluation kernels for sm_90a: three entry points, each its own
// launch with its own count in _build.py.
//
//   fused_votes_batched  client-batched clause eval + Eq.-1 vote (below);
//   clause_outputs       violation count, then == 0 (further down);
//   fused_votes          single-model clause eval + Eq.-1 vote (last).
//
// fused_votes_batched replaces
// src/repro/kernels/clause_eval.py::fused_votes_batched_pallas
// (body _votes_batched_kernel): include (N,C,m,L) x lits (N,B,L) x
// wpol (N,C,m) -> unclipped votes (N,B,C) int32.  A clause fires when none
// of its included literals is 0 in the sample; in predict mode an empty
// clause (nothing included) is silenced by zeroing its weight.
//
// What bounds it on an H100: reading the include plane.  It is N*C*m*L
// bytes (94 MB for 20 clients at C=10, m=300, L=1568), about 28 us at
// 3.35 TB/s, against 2*N*B*C*m*L {0,1} operations that a byte-wise AND +
// popcount does 4 at a time.  The design reads each include word once per
// tile of kBT samples, so the plane crosses device memory ceil(B/kBT)
// times (L2 catches part of it), and it never materialises the (N,B,C*m)
// violation or clause tensor.
//
// Design: one block per (tile of kBT samples, class c, client n).  The
// tile's (1 - lit) rows are staged in shared memory as 32-bit words of
// four 0/1 bytes.  Warps stride over the class's m clauses; lanes stride
// over the words of a clause row (coalesced), and popc(inc & nlit) counts
// the violated literals of four bytes at once, exactly.  A warp shuffle
// sums the counts; each warp keeps its partial vote per sample, and a
// shared-memory pass adds the warps' partials in a fixed order, so the
// result needs no atomics and is the same on every run.
//
// The caller pads L to a multiple of 4 with zero bytes in both operands
// (a zero byte is neither included nor violated).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;   // warps per block
constexpr int kBT = 8;      // samples per block (sample tiles of 1 at B = 1)

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

// Add the warps' per-sample partial votes in a fixed order; thread b < nb
// returns sample b's block total.
template <int BT>
__device__ __forceinline__ int32_t block_votes(const int32_t (&acc)[BT],
                                               int32_t (*s_part)[BT],
                                               int warp, int lane) {
  if (lane == 0) {
#pragma unroll
    for (int b = 0; b < BT; ++b) s_part[warp][b] = acc[b];
  }
  __syncthreads();
  int32_t v = 0;
  if (threadIdx.x < BT) {
#pragma unroll
    for (int k = 0; k < kWarps; ++k) v += s_part[k][threadIdx.x];
  }
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
votes_batched_kernel(const uint32_t* __restrict__ inc,   // (N, C, m, W)
                     const uint32_t* __restrict__ nlit,  // (N, B, W)
                     const int32_t* __restrict__ wpol,   // (N, C, m)
                     int32_t* __restrict__ votes,        // (N, B, C)
                     int C, int m, int W, int B, int predict) {
  extern __shared__ uint32_t s_nlit[];                  // (kBT, W)
  __shared__ int32_t s_part[kWarps][kBT];
  const int b0 = blockIdx.x * kBT;
  const int c = blockIdx.y;
  const int n = blockIdx.z;
  const int nb = min(kBT, B - b0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  stage_rows<kBT>(s_nlit, nlit + ((size_t)n * B + b0) * W, nb, W);
  __syncthreads();

  const uint32_t* bank = inc + ((size_t)n * C + c) * (size_t)m * W;
  const int32_t* wrow = wpol + ((size_t)n * C + c) * m;
  int32_t acc[kBT];
#pragma unroll
  for (int b = 0; b < kBT; ++b) acc[b] = 0;
  for (int j = warp; j < m; j += kWarps) {
    int viol[kBT];
    const bool nonempty = count_row<kBT>(bank + (size_t)j * W, s_nlit, W,
                                         lane, viol);
    const int32_t wp = (predict && !nonempty) ? 0 : wrow[j];
#pragma unroll
    for (int b = 0; b < kBT; ++b) acc[b] += viol[b] == 0 ? wp : 0;
  }
  const int32_t v = block_votes<kBT>(acc, s_part, warp, lane);
  if (threadIdx.x < nb) votes[((size_t)n * B + b0 + threadIdx.x) * C + c] = v;
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
// are staged in shared memory (BT = 1 in training: the one row), and
// count_row gives the counts and the empty-clause rule.
template <int BT>
__global__ void __launch_bounds__(kWarps * 32)
clause_outputs_kernel(const uint32_t* __restrict__ inc,   // (NB, CM, W)
                      const uint32_t* __restrict__ nlit,  // (NB, B, W)
                      int32_t* __restrict__ fired,        // (NB, B, CM)
                      int CM, int W, int B, int predict) {
  extern __shared__ uint32_t s_nlit[];                  // (BT, W)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + warp;
  const int b0 = blockIdx.y * BT;
  const size_t n = blockIdx.z;
  const int nb = min(BT, B - b0);

  stage_rows<BT>(s_nlit, nlit + (n * B + b0) * W, nb, W);
  __syncthreads();
  if (j >= CM) return;                 // the whole warp leaves together

  int viol[BT];
  const bool nonempty = count_row<BT>(inc + (n * CM + j) * (size_t)W, s_nlit,
                                      W, lane, viol);
  const bool silent = predict && !nonempty;
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    if (lane == b && b < nb)
      fired[(n * B + b0 + b) * CM + j] = (!silent && viol[b] == 0) ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// fused_votes: replaces src/repro/kernels/clause_eval.py::fused_votes_pallas
// (body _votes_kernel): include (C, m, L) x lits (B, L) x wpol (C, m) ->
// unclipped votes (B, C) int32 for one model.
//
// What bounds it: reading the include plane, C*m*L bytes (4.7 MB at
// C = 10, m = 300, L = 1568: 1.4 us at 3.35 TB/s), but the serving
// verifier calls it with B = 1, where 10 blocks (one per class, as the
// Pallas grid has it) would leave 122 of 132 SMs idle and the time is
// latency.  So a class's clauses are spread over ceil(m / kWarps) blocks,
// one warp per clause as in clause_outputs, and each block adds its
// partial votes into the output with one integer atomicAdd per sample:
// integer sums are exact in any order, so the result is the same on every
// run.  The entry point zeroes the output first on the same stream.
template <int BT>
__global__ void __launch_bounds__(kWarps * 32)
fused_votes_kernel(const uint32_t* __restrict__ inc,   // (C, m, W)
                   const uint32_t* __restrict__ nlit,  // (B, W)
                   const int32_t* __restrict__ wpol,   // (C, m)
                   int32_t* __restrict__ votes,        // (B, C), zeroed
                   int C, int m, int W, int B, int predict) {
  extern __shared__ uint32_t s_nlit[];                  // (BT, W)
  __shared__ int32_t s_part[kWarps][BT];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + warp;
  const int c = blockIdx.y;
  const int b0 = blockIdx.z * BT;
  const int nb = min(BT, B - b0);

  stage_rows<BT>(s_nlit, nlit + (size_t)b0 * W, nb, W);
  __syncthreads();

  int32_t acc[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) acc[b] = 0;
  if (j < m) {                         // uniform across the warp
    int viol[BT];
    const bool nonempty = count_row<BT>(inc + ((size_t)c * m + j) * W,
                                        s_nlit, W, lane, viol);
    const int32_t wp = (predict && !nonempty) ? 0 : wpol[(size_t)c * m + j];
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[b] = viol[b] == 0 ? wp : 0;
  }
  const int32_t v = block_votes<BT>(acc, s_part, warp, lane);
  if (threadIdx.x < nb && v != 0)
    atomicAdd(votes + (size_t)(b0 + threadIdx.x) * C + c, v);
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

// inc: (N,C,m,W) words, nlit: (N,B,W) words, wpol: (N,C,m) int32,
// votes: (N,B,C) int32.  Launches on `stream`; returns cudaGetLastError().
extern "C" int fused_votes_batched(const void* inc, const void* nlit,
                                   const void* wpol, void* votes, int N,
                                   int C, int m, int W, int B, int predict,
                                   void* stream) {
  if (N == 0 || B == 0 || C == 0) return (int)cudaGetLastError();
  return (int)launch(votes_batched_kernel, kBT,
                     dim3((B + kBT - 1) / kBT, C, N), W, stream,
                     static_cast<const uint32_t*>(inc),
                     static_cast<const uint32_t*>(nlit),
                     static_cast<const int32_t*>(wpol),
                     static_cast<int32_t*>(votes), C, m, W, B, predict);
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

// inc: (C,m,W) words, nlit: (B,W) words, wpol: (C,m) int32, votes: (B,C)
// int32, zeroed here before the launch.  Sample tiles as clause_outputs.
extern "C" int fused_votes(const void* inc, const void* nlit,
                           const void* wpol, void* votes, int C, int m,
                           int W, int B, int predict, void* stream) {
  if (B == 0 || C == 0) return (int)cudaGetLastError();
  const cudaError_t e = cudaMemsetAsync(
      votes, 0, sizeof(int32_t) * B * (size_t)C, (cudaStream_t)stream);
  if (e != cudaSuccess || m == 0) return (int)e;
  const auto* i32 = static_cast<const uint32_t*>(inc);
  const auto* n32 = static_cast<const uint32_t*>(nlit);
  const auto* w32 = static_cast<const int32_t*>(wpol);
  auto* out = static_cast<int32_t*>(votes);
  const int bt = B == 1 ? 1 : kBT;
  const dim3 grid((m + kWarps - 1) / kWarps, C, (B + bt - 1) / bt);
  return (int)(bt == 1
      ? launch(fused_votes_kernel<1>, 1, grid, W, stream, i32, n32, w32, out,
               C, m, W, B, predict)
      : launch(fused_votes_kernel<kBT>, kBT, grid, W, stream, i32, n32, w32,
               out, C, m, W, B, predict));
}
