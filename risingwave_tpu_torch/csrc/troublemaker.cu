// K28: the troublemaker's op corruption (sm_90a).
//
// Replaces risingwave_tpu/stream/troublemaker.py
// `TroublemakerExecutor.apply` (:46): one thread per row of the chunk, in
// native unsigned 64-bit arithmetic (wrapping multiplies, logical shifts,
// an unsigned modulo):
//   h    = mix(row * K1 ^ counter * K2 ^ seed),
//          mix(x) = y ^ (y >> 31) with y = (x ^ (x >> 30)) * K2;
//   flip = h % ratio == 0 & valid & op == Insert;
//   op   = flip ? Delete : op.
// Thread 0 also writes counter + 1 into the new counter (the executor's
// state), so the chunk counter advances in the same launch.
//
// Bound: bytes.  Per row it reads valid and op (2 B) and writes the op
// (1 B); the mix is a handful of integer operations.
#include <cstdint>
#include <cuda_runtime.h>

struct TroublemakerArgs {
  const uint8_t* valid;         // [cap]
  const int8_t* ops;            // [cap]
  int8_t* ops_out;              // [cap]
  const unsigned long long* counter;   // uint64 scalar (the chunk counter)
  unsigned long long* counter_out;     // uint64 scalar: counter + 1
  unsigned long long seed;
  unsigned long long ratio;
  int cap;
};

static constexpr unsigned long long TM_K1 = 0x9E3779B97F4A7C15ull;
static constexpr unsigned long long TM_K2 = 0xBF58476D1CE4E5B9ull;

__global__ void troublemaker_kernel(TroublemakerArgs a) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= a.cap) return;
  const unsigned long long c = *a.counter;
  unsigned long long x = static_cast<unsigned long long>(i) * TM_K1 ^
                         c * TM_K2 ^ a.seed;
  x = (x ^ (x >> 30)) * TM_K2;
  const unsigned long long h = x ^ (x >> 31);
  const int8_t op = a.ops[i];
  const bool flip = h % a.ratio == 0ull && a.valid[i] != 0 && op == 0;
  a.ops_out[i] = flip ? static_cast<int8_t>(1) : op;
  if (i == 0) *a.counter_out = c + 1ull;
}

extern "C" int rw_troublemaker(TroublemakerArgs args, void* stream) {
  if (args.cap > 0) {
    const int threads = 256;
    const int blocks = (args.cap + threads - 1) / threads;
    troublemaker_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}
