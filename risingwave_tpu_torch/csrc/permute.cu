// Kernel K4: the dense row permutation after a rehash or a pool
// compaction (sm_90a).
//
// Replaces risingwave_tpu/state/hash_table.py `permute_dense` (:115-134):
// out[moved[old]] = arr[old] for every old row whose target is below
// `size` (dead rows carry the sentinel `size` and are dropped); rows no
// live row lands on hold `init` (zero without one).  Live targets are
// unique (slots of a fresh table, or pool positions), so no winner needs
// resolving.
//
//   rw_permute_rows  one entry for up to PERM_MAX_COLS columns of one
//                    table (a pool's row columns, or a side's count,
//                    pool_pos and slot_clean), described by value: each
//                    column's input and output rows of `row_bytes` bytes
//                    (a StrCol's [size, w] bytes are one column of w-byte
//                    rows) and its init element pattern.  Two launches on
//                    the stream: a fill of every output row with the init
//                    pattern, then one thread per old row copying its row
//                    of every column to its target (8-byte units where a
//                    row is a multiple of 8 bytes).
//
// Against the plain version it drops the dump row at `size` and the extra
// contiguous copy of the output.
//
// Bound: bytes.  Every input row is read and every output row written
// (the fill writes them twice): 2^22 pool rows of q8's 7 auction columns
// are ~470 MB moved, ~0.14 ms at 3.35 TB/s.
#include <cstdint>
#include <cuda_runtime.h>

#define PERM_MAX_COLS 16

constexpr int PERM_THREADS = 256;

struct PermCol {
  const uint8_t* in;
  uint8_t* out;
  int row_bytes;
  int esize;
  unsigned long long init;  // one element's bit pattern
};

struct PermDesc {
  int n_cols;
  int size;  // rows in and out
  PermCol col[PERM_MAX_COLS];
};

__device__ __forceinline__ void perm_store(uint8_t* p, int esize,
                                           unsigned long long v) {
  switch (esize) {
    case 1: *p = static_cast<uint8_t>(v); break;
    case 2: *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(v); break;
    case 4: *reinterpret_cast<uint32_t*>(p) = static_cast<uint32_t>(v); break;
    default: *reinterpret_cast<unsigned long long*>(p) = v;
  }
}

__global__ void __launch_bounds__(PERM_THREADS)
    permute_fill_kernel(const __grid_constant__ PermDesc d) {
  for (long long r = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       r < d.size; r += static_cast<long long>(gridDim.x) * blockDim.x) {
    for (int c = 0; c < d.n_cols; ++c) {
      const PermCol& C = d.col[c];
      uint8_t* row = C.out + r * C.row_bytes;
      for (int o = 0; o < C.row_bytes; o += C.esize) {
        perm_store(row + o, C.esize, C.init);
      }
    }
  }
}

__global__ void __launch_bounds__(PERM_THREADS)
    permute_scatter_kernel(const __grid_constant__ PermDesc d,
                           const int* moved) {
  for (long long r = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       r < d.size; r += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int t = moved[r];
    if (t < 0 || t >= d.size) continue;  // dead row: the sentinel
    for (int c = 0; c < d.n_cols; ++c) {
      const PermCol& C = d.col[c];
      const uint8_t* src = C.in + r * C.row_bytes;
      uint8_t* dst = C.out + static_cast<long long>(t) * C.row_bytes;
      if ((C.row_bytes & 7) == 0) {
        for (int o = 0; o < C.row_bytes; o += 8) {
          *reinterpret_cast<unsigned long long*>(dst + o) =
              *reinterpret_cast<const unsigned long long*>(src + o);
        }
      } else {
        for (int o = 0; o < C.row_bytes; o += C.esize) {
          perm_store(dst + o, C.esize,
                     C.esize == 1 ? src[o]
                     : C.esize == 2
                         ? *reinterpret_cast<const uint16_t*>(src + o)
                         : *reinterpret_cast<const uint32_t*>(src + o));
        }
      }
    }
  }
}

extern "C" int rw_permute_rows(const PermDesc* desc, const int* moved,
                               void* stream) {
  if (desc->n_cols < 1 || desc->n_cols > PERM_MAX_COLS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (desc->size > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int blocks = (desc->size + PERM_THREADS - 1) / PERM_THREADS;
    if (blocks > 132 * 16) blocks = 132 * 16;
    permute_fill_kernel<<<blocks, PERM_THREADS, 0, s>>>(*desc);
    permute_scatter_kernel<<<blocks, PERM_THREADS, 0, s>>>(*desc, moved);
  }
  return static_cast<int>(cudaGetLastError());
}
