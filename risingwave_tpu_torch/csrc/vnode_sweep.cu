// K26: the vnode sweep of a keyed state table (sm_90a).
//
// Replaces risingwave_tpu/cluster/scale/handover.py `clear_vnodes` (:153),
// `_clear_join_side` (:286) and `_entry_mask` (:78) on live state, and
// risingwave_tpu/sql/engine.py `_vnode_filtered_mv_state` (:3165).
//
// One thread per slot of a table of `size` slots:
//   stale = occupied[s] & member[vnode(key0[s])], the vnode being K25's
//           (rw_common.cuh's rw_vnode_of_int);
// clear form (occ_out == nullptr):
//   - a stale slot becomes a tombstone (occupied = 0, tombstone = 1), as
//     HashTable.clear_where does;
//   - every slot-aligned leaf's row of a stale slot is zeroed: `row_bytes`
//     bytes at leaf + s * row_bytes (an agg's row_count, prev_row_count,
//     dirty, emitted and [size, B] minput_occ; a join side's [size, B]
//     occupied and count) - zero is what the reference writes in every one
//     of them (0, False, o & ~stale);
//   - the stale slots are counted (rw_block_sum_add);
// read form (occ_out given): occ_out[s] = stale, the occupancy narrowed to
//   the member vnodes (a serving read's view); nothing else is written.
//
// Bound: bytes.  Per slot it reads occupied (1 B), and for occupied slots
// the key (8 B); the member mask is read once and stays in cache; a clear
// writes the stale slots' planes and leaf rows.  Each thread writes only its own slot, so the result does
// not depend on the order.
#include "rw_common.cuh"

#define RW_SWEEP_LEAVES 48

struct VnodeSweepArgs {
  const void* key0;        // [size] integer key, `key_width` bytes a slot
  int key_width;
  int size;
  int n_vnodes;
  const uint8_t* member;   // [n_vnodes]
  uint8_t* occupied;       // [size]
  uint8_t* tombstone;      // [size] (clear form)
  uint8_t* occ_out;        // [size] (read form), or null
  unsigned long long* count;  // int64 scalar, added to in place, or null
  int n_leaves;
  void* leaf[RW_SWEEP_LEAVES];
  long long row_bytes[RW_SWEEP_LEAVES];
};

__device__ __forceinline__ void zero_row(void* base, long long row_bytes,
                                         int64_t s) {
  uint8_t* p = static_cast<uint8_t*>(base) + s * row_bytes;
  if ((row_bytes & 7) == 0 && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    uint64_t* q = reinterpret_cast<uint64_t*>(p);
    for (long long j = 0; j < (row_bytes >> 3); ++j) q[j] = 0ull;
  } else if ((row_bytes & 3) == 0 &&
             (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    uint32_t* q = reinterpret_cast<uint32_t*>(p);
    for (long long j = 0; j < (row_bytes >> 2); ++j) q[j] = 0u;
  } else {
    for (long long j = 0; j < row_bytes; ++j) p[j] = 0;
  }
}

__global__ void vnode_sweep_kernel(VnodeSweepArgs a) {
  const int64_t s = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  int stale = 0;
  if (s < a.size && a.occupied[s] != 0) {
    const int vn = rw_vnode_of_int(rw_load_int(a.key0, a.key_width, s),
                                   a.n_vnodes);
    stale = a.member[vn] != 0 ? 1 : 0;
  }
  if (s < a.size) {
    if (a.occ_out != nullptr) {
      a.occ_out[s] = static_cast<uint8_t>(stale);
    } else if (stale) {
      a.occupied[s] = 0;
      a.tombstone[s] = 1;
      for (int l = 0; l < a.n_leaves; ++l) {
        zero_row(a.leaf[l], a.row_bytes[l], s);
      }
    }
  }
  if (a.count == nullptr) return;
  rw_block_sum_add(stale, a.count);
}

extern "C" int rw_vnode_sweep(const VnodeSweepArgs* args, void* stream) {
  if (args->size > 0) {
    const int threads = 256;
    const int blocks = (args->size + threads - 1) / threads;
    vnode_sweep_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(*args);
  }
  return static_cast<int>(cudaGetLastError());
}
