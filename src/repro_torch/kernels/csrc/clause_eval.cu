// Client-batched fused clause evaluation + Eq.-1 class vote, for sm_90a.
//
// Replaces src/repro/kernels/clause_eval.py::fused_votes_batched_pallas
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
constexpr int kBT = 8;      // samples per block

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

  for (int i = threadIdx.x; i < kBT * W; i += blockDim.x) {
    const int b = i / W;
    s_nlit[i] = b < nb ? nlit[((size_t)n * B + b0 + b) * W + (i - b * W)]
                       : 0u;
  }
  __syncthreads();

  const uint32_t* bank = inc + ((size_t)n * C + c) * (size_t)m * W;
  const int32_t* wrow = wpol + ((size_t)n * C + c) * m;
  int32_t acc[kBT];
#pragma unroll
  for (int b = 0; b < kBT; ++b) acc[b] = 0;

  for (int j = warp; j < m; j += kWarps) {
    const uint32_t* row = bank + (size_t)j * W;
    int viol[kBT];
#pragma unroll
    for (int b = 0; b < kBT; ++b) viol[b] = 0;
    uint32_t any = 0;
#pragma unroll 4
    for (int w = lane; w < W; w += 32) {
      const uint32_t x = __ldg(row + w);
      any |= x;
#pragma unroll
      for (int b = 0; b < kBT; ++b) viol[b] += __popc(x & s_nlit[b * W + w]);
    }
#pragma unroll
    for (int b = 0; b < kBT; ++b)
      viol[b] = __reduce_add_sync(0xffffffffu, viol[b]);
    const bool nonempty = __any_sync(0xffffffffu, any != 0u);
    const int32_t wp = (predict && !nonempty) ? 0 : wrow[j];
#pragma unroll
    for (int b = 0; b < kBT; ++b) acc[b] += viol[b] == 0 ? wp : 0;
  }

  if (lane == 0) {
#pragma unroll
    for (int b = 0; b < kBT; ++b) s_part[warp][b] = acc[b];
  }
  __syncthreads();
  if (threadIdx.x < nb) {
    int32_t v = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) v += s_part[k][threadIdx.x];
    votes[((size_t)n * B + b0 + threadIdx.x) * C + c] = v;
  }
}

}  // namespace

// inc: (N,C,m,W) words, nlit: (N,B,W) words, wpol: (N,C,m) int32,
// votes: (N,B,C) int32.  Launches on `stream`; returns cudaGetLastError().
extern "C" int fused_votes_batched(const void* inc, const void* nlit,
                                   const void* wpol, void* votes, int N,
                                   int C, int m, int W, int B, int predict,
                                   void* stream) {
  if (N == 0 || B == 0 || C == 0) return (int)cudaGetLastError();
  const size_t smem = sizeof(uint32_t) * kBT * (size_t)W;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        votes_batched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + kBT - 1) / kBT, C, N);
  votes_batched_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(inc), static_cast<const uint32_t*>(nlit),
      static_cast<const int32_t*>(wpol), static_cast<int32_t*>(votes), C, m,
      W, B, predict);
  return (int)cudaGetLastError();
}
