// Type I / Type II Tsetlin-automaton transition, for sm_90a.
//
// Replaces src/repro/kernels/ta_update.py::ta_update_pallas (body
// _ta_kernel): for NB stacked clause banks ta (NB, m, L) int32 in [1, 2N],
// the literals lit (NB, L), the per-clause flags fired / type1 / type2
// (NB, m) and the uniforms u_inc / u_dec (NB, m, L) float32,
//
//   up1   = type1 & fired & lit & (u_inc < p_inc)
//   down1 = type1 & !(fired & lit) & (u_dec < p_dec)
//   up2   = type2 & fired & !lit & (ta <= N)
//   out   = clamp(ta + up1 - down1 + up2, 1, 2N).
//
// p_inc and p_dec arrive as float32, the value the reference compares its
// float32 uniforms with, so the compare is a float32 compare as there.
//
// What bounds it: device memory.  Every state is read and written once
// (8 bytes); a uniform is read only in rows that take Type I feedback
// (type1 set), where exactly one of the two is needed per literal (4
// bytes).  At 20 banks of 300 x 1568 that is 75 MB plus 4 bytes per Type I
// element, against a handful of integer operations per element.
//
// Design: one block row per clause row (grid y strides over the NB*m
// rows), threads over the row's literals (grid x), so the row's flags are
// uniform across a block and rows without Type I feedback never touch the
// uniform planes.  Loads and stores are coalesced along L.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ta_update_kernel(const int32_t* __restrict__ ta,     // (NB, m, L)
                 const int32_t* __restrict__ lit,    // (NB, L)
                 const int32_t* __restrict__ fired,  // (NB, m)
                 const int32_t* __restrict__ type1,  // (NB, m)
                 const int32_t* __restrict__ type2,  // (NB, m)
                 const float* __restrict__ u_inc,    // (NB, m, L)
                 const float* __restrict__ u_dec,    // (NB, m, L)
                 int32_t* __restrict__ out,          // (NB, m, L)
                 int rows, int m, int L, float p_inc, float p_dec,
                 int n_states) {
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const size_t n = r / m;
    const bool f = fired[r] != 0;
    const bool t1 = type1[r] != 0;
    const bool t2 = type2[r] != 0;
    const size_t base = (size_t)r * L;
    for (int l = blockIdx.x * blockDim.x + threadIdx.x; l < L;
         l += gridDim.x * blockDim.x) {
      const int32_t s = ta[base + l];
      const bool on = lit[n * L + l] != 0;
      int d = 0;
      if (t1) {
        if (f && on)
          d += u_inc[base + l] < p_inc ? 1 : 0;
        else
          d -= u_dec[base + l] < p_dec ? 1 : 0;
      }
      if (t2 && f && !on && s <= n_states) d += 1;
      out[base + l] = min(max(s + d, 1), 2 * n_states);
    }
  }
}

}  // namespace

// All planes contiguous; rows = NB * m.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int ta_update(const void* ta, const void* lit, const void* fired,
                         const void* type1, const void* type2,
                         const void* u_inc, const void* u_dec, void* out,
                         int NB, int m, int L, float p_inc, float p_dec,
                         int n_states, void* stream) {
  const int rows = NB * m;
  if (rows == 0 || L == 0) return (int)cudaGetLastError();
  const dim3 grid((L + kThreads - 1) / kThreads, rows < 65535 ? rows : 65535);
  ta_update_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(ta), static_cast<const int32_t*>(lit),
      static_cast<const int32_t*>(fired), static_cast<const int32_t*>(type1),
      static_cast<const int32_t*>(type2), static_cast<const float*>(u_inc),
      static_cast<const float*>(u_dec), static_cast<int32_t*>(out), rows, m,
      L, p_inc, p_dec, n_states);
  return (int)cudaGetLastError();
}
