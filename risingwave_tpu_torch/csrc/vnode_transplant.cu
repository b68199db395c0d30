// K27: the transplant scatter of a handover (sm_90a).
//
// Replaces risingwave_tpu/cluster/scale/handover.py `transplant` (:387),
// `_transplant_join_side` (:298) and `_scatter_bucket` (:234), and the
// `_scatter_col` of risingwave_tpu/stream/materialize.py they call: every
// slot-aligned leaf of the recipient takes the donor slice's row r at the
// slot the probe kernel claimed for it, `store[slots[r]] = src[r]`, with
// slots >= size dropped (the reference's mode="drop").  It is the inverse
// of K11's gather: one launch per moved slice, over all its leaves (an
// agg's prims, prev_prims, row_count, prev_row_count, dirty, emitted and
// minput buckets; an MV's value columns; a join side's [size, B] row
// stores, occupied and count), each leaf a `row_bytes`-wide row.
//
// One thread per (entry, leaf) pair copies the row in 8-, 4- or 1-byte
// words.  The claimed slots of one slice are distinct (one slot per key),
// so no two threads write the same bytes.
//
// Bound: bytes.  It reads each leaf's n rows and the n slots once and
// writes n rows per leaf.
#include <cstdint>
#include <cuda_runtime.h>

#define RW_TRANSPLANT_LEAVES 48

struct TransplantArgs {
  const int* slots;        // [n] claimed slots (size = dropped)
  int n;
  int size;
  int n_leaves;
  const void* src[RW_TRANSPLANT_LEAVES];   // [n, ...] donor rows
  void* dst[RW_TRANSPLANT_LEAVES];         // [size, ...] live stores
  long long row_bytes[RW_TRANSPLANT_LEAVES];
};

__global__ void vnode_transplant_kernel(TransplantArgs a) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (t >= static_cast<int64_t>(a.n) * a.n_leaves) return;
  const int64_t r = t / a.n_leaves;
  const int l = static_cast<int>(t % a.n_leaves);
  const int s = a.slots[r];
  if (s < 0 || s >= a.size) return;
  const long long rb = a.row_bytes[l];
  const uint8_t* ps = static_cast<const uint8_t*>(a.src[l]) + r * rb;
  uint8_t* pd = static_cast<uint8_t*>(a.dst[l]) + s * rb;
  const uintptr_t al = reinterpret_cast<uintptr_t>(ps) |
                       reinterpret_cast<uintptr_t>(pd);
  if ((rb & 7) == 0 && (al & 7) == 0) {
    for (long long j = 0; j < (rb >> 3); ++j) {
      reinterpret_cast<uint64_t*>(pd)[j] =
          reinterpret_cast<const uint64_t*>(ps)[j];
    }
  } else if ((rb & 3) == 0 && (al & 3) == 0) {
    for (long long j = 0; j < (rb >> 2); ++j) {
      reinterpret_cast<uint32_t*>(pd)[j] =
          reinterpret_cast<const uint32_t*>(ps)[j];
    }
  } else {
    for (long long j = 0; j < rb; ++j) pd[j] = ps[j];
  }
}

extern "C" int rw_vnode_transplant(const TransplantArgs* args,
                                   void* stream) {
  const long long work = static_cast<long long>(args->n) * args->n_leaves;
  if (work > 0) {
    const int threads = 256;
    const long long blocks = (work + threads - 1) / threads;
    vnode_transplant_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(*args);
  }
  return static_cast<int>(cudaGetLastError());
}
