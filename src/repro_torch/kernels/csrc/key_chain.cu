// The key chain of one local epoch for N clients, in one launch, for
// sm_90a: each (client, sample)'s class pair and role keys, which the fused
// epoch (train_epoch.cu) and the TA transition (ta_update.cu) draw from.
//
// Replaces no TPU kernel.  The JAX package leaves the chain to XLA (the key
// splits and randint of src/repro/kernels/draws.py::epoch_draws and the
// class pairs of src/repro/core/tm.py); the port's plain version
// (repro_torch/kernels/key_chain.py::key_chain_plain) runs it as small
// torch ops, about a thousand launches an epoch whose device work is
// microseconds: the host's time to launch them, not the card, set its
// cost.  Here one thread computes one sample's chain, threefry::sample_chain
// (threefry.h, which the CPU tests build with a host compiler and hold
// against jax.random), from its client's key and the epoch index, so the
// epoch keys need no launch of their own either.
//
// What bounds it on an H100: at the largest shape the benchmark runs (20
// clients x 2,400 samples) 48,000 threads hash 15 times each (720,000
// threefry-2x32 hashes, about 62 int32 instructions each: 2.7 us at 16.75
// T/s) and write 104 bytes each (5.0 MB: 1.5 us at 3.35 TB/s); at the
// smaller shapes less.  Its launch takes longer than either, so the design
// is the simplest that writes each output once: a thread's eight bytes of
// cls2 in one 64-bit store, its 96 bytes of role keys in six 128-bit stores.
#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.h"

namespace {

constexpr int kThreads = 128;

struct Args {
  int32_t* cls2;        // (N, S, 2)
  int64_t* role_keys;   // (N, S, 2, 3, 2), uint32 words
  const int64_t* keys;  // client (epoch < 0: epoch) keys, uint32 words
  long long key_row, key_word;
  const void* ys;       // (N, S) labels, int32 or int64 (y_wide)
  long long y_row, y_col;
  int y_wide, N, S, C, epoch;
};

__global__ void __launch_bounds__(kThreads) key_chain_kernel(Args a) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)a.N * a.S) return;
  const long long n = t / a.S, i = t - n * a.S;
  const int64_t* key = a.keys + n * a.key_row;
  const long long yi = n * a.y_row + i * a.y_col;
  const int32_t y =
      a.y_wide ? (int32_t)static_cast<const int64_t*>(a.ys)[yi]
               : static_cast<const int32_t*>(a.ys)[yi];
  const threefry::SampleChain c = threefry::sample_chain(
      (uint32_t)key[0], (uint32_t)key[a.key_word], a.epoch, (uint32_t)i, y,
      a.C);
  reinterpret_cast<int2*>(a.cls2)[t] = make_int2(c.cls[0], c.cls[1]);
  longlong2* out = reinterpret_cast<longlong2*>(a.role_keys) + 6 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[3 * r + j] = make_longlong2(c.role[r][j][0], c.role[r][j][1]);
}

}  // namespace

// One epoch's chain: cls2 (N, S, 2) int32 and role_keys (N, S, 2, 3, 2)
// int64, contiguous and 16-byte aligned, from keys (N, 2) int64 (rows
// key_row, words key_word elements apart) and the labels ys (N, S), int32
// or, with y_wide, int64 (rows y_row, samples y_col elements apart).  epoch
// >= 0: the keys are the clients' and the epoch key is split(key,
// epochs)[epoch]; epoch < 0: the keys are the epoch keys.  C >= 1 and
// N * S below 2**31.  Launches on `stream` (nothing where N * S = 0);
// returns cudaGetLastError().
extern "C" int key_chain(void* cls2, void* role_keys, const void* keys,
                         long long key_row, long long key_word,
                         const void* ys, int y_wide, long long y_row,
                         long long y_col, int N, int S, int C, int epoch,
                         void* stream) {
  const long long threads = (long long)N * S;
  if (threads == 0) return (int)cudaGetLastError();
  Args a;
  a.cls2 = static_cast<int32_t*>(cls2);
  a.role_keys = static_cast<int64_t*>(role_keys);
  a.keys = static_cast<const int64_t*>(keys);
  a.key_row = key_row;
  a.key_word = key_word;
  a.ys = ys;
  a.y_row = y_row;
  a.y_col = y_col;
  a.y_wide = y_wide;
  a.N = N;
  a.S = S;
  a.C = C;
  a.epoch = epoch;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  key_chain_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
