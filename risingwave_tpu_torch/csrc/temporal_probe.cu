// K22a: the temporal join's probe-and-gather (sm_90a).
//
// Replaces risingwave_tpu/stream/temporal_join.py
// `TemporalJoinExecutor.apply` (:80), its left side: each probe row's pk
// lookup in the build table (`HashTable.lookup_counted`,
// state/hash_table.py:205, over `_probe` :236), the gather of every build
// value leaf at the found slot, the output's valid plane (`valid & found`
// for an inner join, `valid` for a left outer one), the left outer join's
// NULL plane (`miss | null`), and the probe-bound overflow count.
//
// A row takes part when its chunk row is valid and none of its key columns
// is NULL (SQL equality: NULL matches nothing).  Its first slot comes from
// K1 (`start` = hash & (size - 1), computed once by hash64.cu); the walk is
// rw_probe.cuh's, the one kernel B replays in rounds, so a row visits the
// reference's slots in its order, compares keys as `_keys_equal` does
// (strings by every byte and their lengths, floats with subnormals as zero)
// and stops after the same min(size + 2, 1024) steps.
//
// Every output row is written, as the reference's gather writes it: a row
// that found nothing (a miss, an invalid row, an overflow) reads the last
// slot, `min(slot, size - 1)`.  Value leaves are copied whole, in 16-byte
// words where a row's width allows (string bytes: the padding past the
// length included), so the output compares tensor for tensor.
//
// Design: a lookup claims nothing, so rows are independent: one thread a
// probe row over a grid of 256-thread blocks; the table is read-only here.
// The overflow count is one `__syncthreads_count` and one atomicAdd a block
// into the join state's int64 counter.
//
// Bound: bytes.  A probe row reads its key, the slots its walk visits
// (occupied, tombstone, the stored key) and one build row, and writes one
// output row; at 8192 rows of a 2^14 table 61% full that is well under a
// megabyte, a fraction of a microsecond at HBM rate, so the kernel runs at
// its launch latency and the dependent random reads of a walk.
#include "rw_probe.cuh"

struct TemporalProbeArgs {
  RwCols keys;        // in = probe key payloads, st = the table's key store
  RwCols vals;        // in = build value stores (read at the slot),
                      // st = output leaves; null planes beside each
  const uint8_t* key_null[RW_MAX_COLS];  // a key leaf's NULL plane or null
  const int32_t* start;                  // [cap] K1's first slot
  const uint8_t* valid;                  // [cap] the chunk's valid plane
  const uint8_t* occupied;               // [size]
  const uint8_t* tombstone;              // [size]
  uint8_t* out_valid;                    // [cap] out
  unsigned long long* overflow;          // [1] added to in place
  int cap;
  int size;
  int max_iters;
  int left_outer;
};

__device__ __forceinline__ void tj_copy(uint8_t* dst, const uint8_t* src,
                                        int w) {
  if ((w & 15) == 0) {
    for (int j = 0; j < w; j += 16) {
      *reinterpret_cast<uint4*>(dst + j) =
          *reinterpret_cast<const uint4*>(src + j);
    }
  } else if ((w & 7) == 0) {
    for (int j = 0; j < w; j += 8) {
      *reinterpret_cast<uint64_t*>(dst + j) =
          *reinterpret_cast<const uint64_t*>(src + j);
    }
  } else if ((w & 3) == 0) {
    for (int j = 0; j < w; j += 4) {
      *reinterpret_cast<uint32_t*>(dst + j) =
          *reinterpret_cast<const uint32_t*>(src + j);
    }
  } else {
    for (int j = 0; j < w; ++j) dst[j] = src[j];
  }
}

__global__ void __launch_bounds__(256)
    temporal_probe_kernel(TemporalProbeArgs a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  bool over = false;
  if (r < a.cap) {
    const bool valid = a.valid[r] != 0;
    bool live = valid;
    for (int k = 0; k < a.keys.n; ++k) {
      if (a.key_null[k] != nullptr && a.key_null[k][r] != 0) live = false;
    }
    int slot = a.size;
    if (live) {
      slot = rw_lookup_walk(a.keys, a.occupied, a.tombstone, a.start[r],
                            a.size, a.max_iters, r, &over);
    }
    const bool found = slot < a.size;
    const int64_t safe = found ? slot : a.size - 1;
    const bool pad = a.left_outer && !found;
    for (int k = 0; k < a.vals.n; ++k) {
      const int w = a.vals.width[k];
      tj_copy(static_cast<uint8_t*>(a.vals.st_data[k]) + r * int64_t(w),
              static_cast<const uint8_t*>(a.vals.in_data[k]) + safe * w, w);
      if (a.vals.st_null[k] != nullptr) {
        const uint8_t n =
            a.vals.in_null[k] != nullptr ? a.vals.in_null[k][safe] : 0;
        a.vals.st_null[k][r] = (n != 0 || pad) ? 1 : 0;
      }
    }
    a.out_valid[r] = (valid && (a.left_outer || found)) ? 1 : 0;
  }
  const int n_over = __syncthreads_count(over);
  if (threadIdx.x == 0 && n_over != 0) {
    atomicAdd(a.overflow, static_cast<unsigned long long>(n_over));
  }
}

extern "C" int rw_temporal_probe(TemporalProbeArgs args, void* stream) {
  const int threads = 256;
  const int blocks = (args.cap + threads - 1) / threads;
  if (blocks > 0) {
    temporal_probe_kernel<<<blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}
