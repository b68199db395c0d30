// The open-addressing probe walk of risingwave_tpu/state/hash_table.py
// `HashTable._probe` (:236), shared by kernel B (probe.cu: find-or-claim
// in rounds) and K22a (temporal_probe.cu: lookups, one thread a row).
//
// One step reads the slot `c` a row's walk has reached, as the reference's
// round does: a key match resolves the row; a true-empty slot (neither
// occupied nor tombstoned) ends a lookup as a miss and is where an insert
// claims; an occupied non-match or a tombstone advances the row's offset.
// A lookup claims nothing, so its rows are independent and its round `it`
// is the row's offset `it`: the walk below visits the reference's slots in
// its order and stops after the same `max_iters` = min(size + 2, 1024)
// steps, the rows still unresolved being its probe-bound overflow.
#pragma once

#include "rw_common.cuh"

#define RW_PROBE_HIT 0
#define RW_PROBE_EMPTY 1
#define RW_PROBE_NEXT 2

__device__ __forceinline__ int rw_probe_step(const RwCols& keys,
                                             const uint8_t* occupied,
                                             const uint8_t* tombstone, int c,
                                             int64_t row) {
  const bool occ = occupied[c] != 0;
  const bool tomb = tombstone[c] != 0 && !occ;
  if (occ && rw_keys_equal(keys, c, row)) return RW_PROBE_HIT;
  if (!occ && !tomb) return RW_PROBE_EMPTY;
  return RW_PROBE_NEXT;
}

// The lookup of input row `row` from its first slot `start`: the slot of
// its key, or `size` when the key is absent or the walk overflowed
// (`*over` set).
__device__ __forceinline__ int rw_lookup_walk(const RwCols& keys,
                                              const uint8_t* occupied,
                                              const uint8_t* tombstone,
                                              int start, int size,
                                              int max_iters, int64_t row,
                                              bool* over) {
  const int mask = size - 1;
  for (int off = 0; off < max_iters; ++off) {
    const int c = (start + off) & mask;
    const int s = rw_probe_step(keys, occupied, tombstone, c, row);
    if (s == RW_PROBE_HIT) return c;
    if (s == RW_PROBE_EMPTY) return size;
  }
  *over = true;
  return size;
}
