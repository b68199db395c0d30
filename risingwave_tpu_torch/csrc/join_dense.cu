// Kernel K13d: the dense (bucket) side update of the hash join (sm_90a).
//
// Replaces risingwave_tpu/stream/hash_join.py `_update_side` (:492) with
// `_bucket_row_hash` (:685): a retractable chunk applied to a side that
// keeps a key table over [size, B] bucket stores, an occupancy bitmap and
// a per-key count.  Before it: K1 hashes the chunk's whole rows, K3 finds
// or claims the insert rows' key slots and looks up the delete rows', and
// K13's rank launch (after a stable sort) ranks the surviving deletes
// among rows of equal row hash and the inserts among rows of equal slot.
//
//   rw_bucket_cancel in-chunk annihilation, before K3: over the rows
//                    stably sorted by row hash (inserts and deletes; the
//                    rest last under the all-ones sentinel) one 1024-thread
//                    block finds each segment's start (a running max),
//                    the exclusive counts of inserts and deletes before
//                    each position (block scans) and each segment's totals
//                    (written at its start); the k-th insert of a row
//                    value cancels against the k-th delete of it, as the
//                    reference's `ins_rank < n_del` / `del_rank < n_ins`.
//   rw_join_dense    four grid launches, in the reference's order:
//     find_clears    one thread per surviving delete row walks its key's
//                    B entries, hashes every occupied one with K1's device
//                    function (`rw_hash_row`, strings and null planes
//                    included) and picks the del_rank-th entry whose hash
//                    equals the row's; a delete whose key or value is
//                    missing counts into `inconsistency`.  It only reads
//                    the occupancy, so every delete sees the pre-delete
//                    state, as the reference's vectorised pass does;
//     apply_clears   clears the picked entries and decrements the counts
//                    (picked entries are distinct: equal values differ in
//                    rank, unequal values in hash);
//     find_takes     one thread per insert row picks the ins_rank-th free
//                    position of its key's POST-delete bucket, reading the
//                    occupancy only (the reference computes `free` once,
//                    before any insert lands); a row with no free position
//                    counts into `overflow`, as do K3's probe overflows;
//     apply_takes    marks the taken positions, scatters the rows' leaves
//                    (strings as bytes plus lengths, null planes) and
//                    increments the counts.
//   Splitting each phase into a read-only pick and a write launch keeps
//   the picks exact without atomics on the bitmap.  The annihilation and
//   the bucket walk live in rw_bucket.cuh, shared with K6m (agg_minput.cu).
//
// Bound: bytes.  A delete reads its bucket's B occupancy bytes and hashes
// the occupied rows' columns (q101: 64 x 16 B at most), an insert reads B
// bytes and writes its row once; the counts are 4-byte atomics.  The
// cancel pass is one block over the chunk (a few scans), latency-bound.
#include "rw_bucket.cuh"
#include "rw_common.cuh"
#include "rw_join.cuh"

struct JoinDenseArgs {
  JoinCols cols;               // src = chunk leaves [cap], dst = [size*B]
  RwCols hash;                 // in_data = the stores' [size*B] leaves
  const long long* row_hash;   // [cap] K1 over the chunk's whole rows
  const uint8_t* is_ins;       // [cap] surviving inserts (before K3)
  const uint8_t* ins_over;     // [cap] K3: no key slot
  const int* slots_ins;        // [cap] K3: insert key slots
  const int* ins_rank;         // [cap] rank among inserts of equal slot
  const uint8_t* is_del;       // [cap] surviving deletes
  const uint8_t* found_del;    // [cap] K3: key found
  const int* slots_del;        // [cap]
  const int* del_rank;         // [cap] rank among found deletes of a value
  const long long* probe_over; // [1] K3's probe-bound count (deletes)
  uint8_t* occupied;           // [size * B]
  int* count;                  // [size]
  long long* overflow;         // [1]
  long long* inconsistency;    // [1]
  int* clear_pos;              // [cap] scratch: flat entry to clear or -1
  int* take_pos;               // [cap] scratch: flat entry to take or -1
  int cap;
  int size;
  int B;
};

__device__ __forceinline__ int clamp_slot(int s, int size) {
  return s < size - 1 ? s : size - 1;
}

// a stored row whose K1 hash equals the delete row's
struct HashEq {
  RwCols hash;
  uint64_t h;
  __device__ __forceinline__ bool operator()(long long e) const {
    return rw_hash_row(hash, e) == h;
  }
};

__global__ void find_clears_kernel(JoinDenseArgs a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.cap) return;
  if (r == 0) atomicAdd(reinterpret_cast<unsigned long long*>(a.overflow),
                        static_cast<unsigned long long>(a.probe_over[0]));
  int pos = -1;
  if (a.is_del[r]) {
    if (a.found_del[r]) {
      const long long base =
          static_cast<long long>(clamp_slot(a.slots_del[r], a.size)) * a.B;
      pos = rw_bucket_pick(a.occupied, base, a.B, true, a.del_rank[r],
                           HashEq{a.hash,
                                  static_cast<uint64_t>(a.row_hash[r])});
    }
    if (pos < 0) {
      atomicAdd(reinterpret_cast<unsigned long long*>(a.inconsistency), 1ull);
    }
  }
  a.clear_pos[r] = pos;
}

__global__ void apply_clears_kernel(JoinDenseArgs a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.cap) return;
  const int p = a.clear_pos[r];
  if (p < 0) return;
  a.occupied[p] = 0;
  atomicSub(&a.count[p / a.B], 1);
}

__global__ void find_takes_kernel(JoinDenseArgs a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.cap) return;
  int pos = -1;
  if (a.is_ins[r]) {
    if (!a.ins_over[r]) {
      const long long base =
          static_cast<long long>(clamp_slot(a.slots_ins[r], a.size)) * a.B;
      pos = rw_bucket_pick(a.occupied, base, a.B, false, a.ins_rank[r],
                           RwAny{});
    }
    if (pos < 0) {
      atomicAdd(reinterpret_cast<unsigned long long*>(a.overflow), 1ull);
    }
  }
  a.take_pos[r] = pos;
}

__global__ void apply_takes_kernel(JoinDenseArgs a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.cap) return;
  const int p = a.take_pos[r];
  if (p < 0) return;
  a.occupied[p] = 1;
  for (int k = 0; k < a.cols.n; ++k) {
    rw_copy_row(a.cols.dst[k], p, a.cols.src[k], r, a.cols.width[k]);
  }
  atomicAdd(&a.count[p / a.B], 1);
}

extern "C" int rw_join_dense(JoinDenseArgs args, void* stream) {
  if (args.cap > 0) {
    const int threads = 256;
    const int blocks = (args.cap + threads - 1) / threads;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    find_clears_kernel<<<blocks, threads, 0, s>>>(args);
    apply_clears_kernel<<<blocks, threads, 0, s>>>(args);
    find_takes_kernel<<<blocks, threads, 0, s>>>(args);
    apply_takes_kernel<<<blocks, threads, 0, s>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}
