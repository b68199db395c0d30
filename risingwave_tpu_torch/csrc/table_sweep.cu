// The K4 sweep: tombstone hash-table entries by predicate or slot list
// (sm_90a).
//
// Replaces risingwave_tpu/state/hash_table.py `HashTable.clear_where`
// (:330), `HashTable.clear_slots` (:344), `TagTable.clear_where` (:670) and
// `TagTable.clear_slots` (:678).  Cleared entries become tombstones, so
// probe chains stay intact:
//   - a HashTable keeps two bool planes: a cleared slot gets occupied = 0,
//     tombstone = 1;
//   - a TagTable keeps one int64 tag per slot: a cleared slot gets TOMB_TAG
//     (1); it is occupied while its tag is neither EMPTY (0) nor TOMB.
// Two forms, one thread per element:
//   predicate  pred [size]: the occupied slots where pred holds clear
//              (`dead = pred & occupied`);
//   slot list  slots [n] int32 and mask [n]: slot slots[r] clears for
//              every row r with mask[r] and slots[r] < size (the `size`
//              sentinel drops, as the reference's mode="drop").  As in the
//              reference, a listed slot clears whether or not it was
//              occupied.
// Each thread writes only its own slot (predicate form) or a listed slot
// with constant values (slot list: duplicates write the same bytes), so
// the result is the reference's whatever the order.
//
// Bound: bytes, counted from the elements the work needs.  The predicate
// form reads pred (1 B a slot), the occupancy (1 B, or the 8 B tag) of the
// predicated slots alone and writes the cleared ones; the slot list reads
// the mask (1 B a row), the slot of the masked rows alone (4 B) and writes
// their slots' planes.
#include <cstdint>
#include <cuda_runtime.h>

struct TableSweepArgs {
  uint8_t* occupied;      // [size] HashTable plane, or null (TagTable)
  uint8_t* tombstone;     // [size] HashTable plane, or null (TagTable)
  long long* tags;        // [size] TagTable tags, or null (HashTable)
  const uint8_t* pred;    // [size] predicate form, or null
  const int* slots;       // [n] slot-list form, or null
  const uint8_t* mask;    // [n] slot-list form
  int n;                  // size (predicate form) or rows (slot list)
  int size;
};

static constexpr long long SWEEP_EMPTY_TAG = 0;
static constexpr long long SWEEP_TOMB_TAG = 1;

__device__ __forceinline__ void clear_slot(const TableSweepArgs& a,
                                           long long s) {
  if (a.tags != nullptr) {
    a.tags[s] = SWEEP_TOMB_TAG;
  } else {
    a.occupied[s] = 0;
    a.tombstone[s] = 1;
  }
}

__global__ void table_sweep_kernel(TableSweepArgs a) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= a.n) return;
  if (a.pred != nullptr) {
    if (!a.pred[i]) return;
    const bool occ = a.tags != nullptr
                         ? (a.tags[i] != SWEEP_EMPTY_TAG &&
                            a.tags[i] != SWEEP_TOMB_TAG)
                         : a.occupied[i] != 0;
    if (occ) clear_slot(a, i);
    return;
  }
  if (!a.mask[i]) return;
  const int s = a.slots[i];
  if (s >= 0 && s < a.size) clear_slot(a, s);
}

extern "C" int rw_table_sweep(TableSweepArgs args, void* stream) {
  if (args.n > 0) {
    const int threads = 256;
    const long long blocks = (static_cast<long long>(args.n) + threads - 1) /
                             threads;
    table_sweep_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}
