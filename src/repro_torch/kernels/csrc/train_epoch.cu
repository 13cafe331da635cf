// One fused Tsetlin-Machine training epoch over N stacked clients, for
// sm_90a.
//
// Replaces src/repro/kernels/train_epoch.py::train_epoch_pallas (body
// _epoch_kernel).  For each client, a loop of 2*S steps over (sample s,
// role r in {target, negative}) on the class bank cls2[n,s,r]:
//   1. clause outputs on the sample's literals (empty clauses fire);
//   2. the Eq.-1 vote sum_j fired_j * pol_j * w_j, clipped to [-T, T];
//   3. activation u_act < (T -/+ v) * f32(1/2T) and the Type I / Type II
//      choice per clause (Type I on same-polarity clauses
//      of the target, opposite-polarity of the negative; Type II the
//      complement);
//   4. the TA transition from the pre-compared coin bits (bit 1: increment
//      hit, bit 2: decrement hit), clamped to [1, 2*n_states], and the
//      weight update floored at 0.
// The result is bit-identical to the Pallas kernel and to the reference
// per-sample scan: every count is an exact integer, and the one float
// operation is the one XLA compiles the reference's "/ (2T)" to: a
// multiply by the correctly rounded f32 reciprocal of 2T, formed here
// with an IEEE divide (no fast math).
//
// What bounds it on an H100: device memory.  An epoch must read and
// write the banks once (2 * 376 MB for 20 clients at C=10, m=300,
// L=1568) and read the coin rows of the clauses that take Type I
// feedback: at most the m/2 same-polarity clauses of each step, and of
// those only the active ones, so at most half of the N*S*2*m*L-byte
// coin plane (0.75 of 1.5 GB for 80 samples): at most about 0.45 ms at
// 3.35 TB/s, less as fewer clauses activate.  Type II feedback reads no
// coins.  This kernel is further
// from that than the bound says: each step is a chain of dependent
// phases over one client's (m, L) bank, so the work of a client cannot
// spread over SMs without a reduction across blocks.
//
// Design: one block per client, so 20 clients use 20 of the 132 SMs
// (spreading a client over a thread-block cluster is later work).  The
// banks are updated in place in device memory, on a copy the caller
// makes.  Each step's phases are separated by __syncthreads(): warps
// stride over clauses and lanes over literals (coalesced) for the
// violation count; a warp-shuffle plus shared-memory reduction gives the
// int32 vote; one thread forms p_act; every thread then classifies its
// clauses; and only rows with Type I or Type II feedback are read and
// written in the TA pass, together with their coin row.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
train_epoch_kernel(int32_t* __restrict__ ta,            // (N, C, m, L)
                   int32_t* __restrict__ w,             // (N, C, m)
                   const int32_t* __restrict__ lits,    // (N, S, L)
                   const int32_t* __restrict__ cls2,    // (N, S, 2)
                   const float* __restrict__ u_act,     // (N, S, 2, m)
                   const int8_t* __restrict__ coin,     // (N, S, 2, m, L)
                   int C, int m, int L, int S, int n_states, int T) {
  extern __shared__ uint8_t smem[];
  uint8_t* s_lit = smem;           // (L,) literal is 1
  uint8_t* s_fired = s_lit + L;    // (m,)
  uint8_t* s_type = s_fired + m;   // (m,) 0 none, 1 Type I, 2 Type II
  __shared__ int32_t s_red[kWarps];
  __shared__ float s_pact;

  const int n = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int two_n = 2 * n_states;

  for (int step = 0; step < 2 * S; ++step) {
    const int s = step >> 1;
    const int role = step & 1;                 // 0 target, 1 negative
    const size_t ns = (size_t)n * S + s;
    const int cls = cls2[ns * 2 + role];
    int32_t* bank = ta + ((size_t)n * C + cls) * (size_t)m * L;
    int32_t* wrow = w + ((size_t)n * C + cls) * m;
    const int32_t* lit = lits + ns * L;

    for (int l = threadIdx.x; l < L; l += kThreads) s_lit[l] = lit[l] != 0;
    __syncthreads();

    // 1. clause outputs in learning mode
    for (int j = warp; j < m; j += kWarps) {
      const int32_t* row = bank + (size_t)j * L;
      int viol = 0;
#pragma unroll 8
      for (int l = lane; l < L; l += 32)
        viol += (row[l] > n_states) & (s_lit[l] ^ 1);
      viol = __reduce_add_sync(0xffffffffu, viol);
      if (lane == 0) s_fired[j] = viol == 0;
    }
    __syncthreads();

    // 2. the int32 vote of this class
    int32_t part = 0;
    for (int j = threadIdx.x; j < m; j += kThreads)
      if (s_fired[j]) part += (j & 1) ? -wrow[j] : wrow[j];
    part = __reduce_add_sync(0xffffffffu, part);
    if (lane == 0) s_red[warp] = part;
    __syncthreads();
    if (threadIdx.x == 0) {
      int32_t v = 0;
      for (int k = 0; k < kWarps; ++k) v += s_red[k];
      v = min(max(v, -T), T);
      // XLA's x / c for a constant c: x * f32(1/c), 1/c correctly rounded
      const float inv = 1.0f / (float)(2 * T);
      s_pact = (float)(role == 0 ? T - v : T + v) * inv;
    }
    __syncthreads();

    // 3. activation, feedback type and the weight update
    const float p_act = s_pact;
    const float* ua = u_act + (ns * 2 + role) * m;
    for (int j = threadIdx.x; j < m; j += kThreads) {
      const bool active = ua[j] < p_act;
      const bool same = ((j & 1) == 0) == (role == 0);
      const int type1 = active && same;
      const int type2 = active && !same;
      s_type[j] = (uint8_t)(type1 | (type2 << 1));
      const int fired = s_fired[j];
      wrow[j] = max(wrow[j] + (type1 & fired) - (type2 & fired), 0);
    }
    __syncthreads();

    // 4. TA transitions on the rows that receive feedback
    const int8_t* cn = coin + (ns * 2 + role) * (size_t)m * L;
    for (int j = warp; j < m; j += kWarps) {
      const int type = s_type[j];
      if (type == 0) continue;
      const bool fired = s_fired[j];
      int32_t* row = bank + (size_t)j * L;
      if (type == 1) {
        const int8_t* crow = cn + (size_t)j * L;
#pragma unroll 4
        for (int l = lane; l < L; l += 32) {
          const int c = crow[l];
          const bool hit = fired && s_lit[l];
          const int d = (hit && (c & 1)) - (!hit && (c & 2));
          row[l] = min(max(row[l] + d, 1), two_n);
        }
      } else if (fired) {
#pragma unroll 4
        for (int l = lane; l < L; l += 32) {
          const int32_t a = row[l];
          if (!s_lit[l] && a <= n_states) row[l] = min(a + 1, two_n);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Updates ta (N,C,m,L) and w (N,C,m) in place.  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int train_epoch_fused(void* ta, void* w, const void* lits,
                                 const void* cls2, const void* u_act,
                                 const void* coin, int N, int C, int m,
                                 int L, int S, int n_states, int T,
                                 void* stream) {
  if (N == 0 || S == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)L + 2 * (size_t)m;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        train_epoch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  train_epoch_kernel<<<N, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<int32_t*>(ta), static_cast<int32_t*>(w),
      static_cast<const int32_t*>(lits), static_cast<const int32_t*>(cls2),
      static_cast<const float*>(u_act), static_cast<const int8_t*>(coin), C,
      m, L, S, n_states, T);
  return (int)cudaGetLastError();
}
