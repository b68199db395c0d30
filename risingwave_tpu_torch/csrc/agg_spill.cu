// The hash aggregation's spill capture (sm_90a).
//
// Replaces risingwave_tpu/stream/hash_agg.py `apply`'s spill ring branch
// (:427-481): the input rows whose group found no table slot divert into a
// ring of R rows instead of being lost.  On the pre-aggregation branch a
// segment's representative probed the table for the whole segment, so
// every valid row of an overflowed segment diverts (the reference's
// `seg_over[seg_id]` scattered back through `perm`); on the per-row branch
// the valid rows that overflowed do.  The rows go, in chunk order, to ring
// positions spill_count + rank; the count advances clamped at R, and the
// rows past R add to the overflow counter (they are lost, loudly).
//
// One 1024-thread block, each thread owning a contiguous run of positions
// (the join kernels' layout): on the pre-aggregation branch it numbers the
// segments by a block scan of the start flags, marks the overflowed
// segments, and scatters the row-order mask through `perm`; then a block
// scan of the mask in row order ranks the rows, and each thread copies its
// rows' leaves (strings as bytes plus lengths, null planes) and op.  It
// runs every chunk and writes nothing but the unchanged count while no row
// overflows (the reference's `lax.cond`), and never reads the host.
//
// Bound: bytes.  A clean chunk reads its flags (a few bytes a row); a
// spilled row moves its columns once (q101's bid rows: ~100 B).  One block
// over 8192 rows is latency-bound.
#include "rw_common.cuh"
#include "rw_join.cuh"

struct AggSpillArgs {
  JoinCols cols;            // src = chunk leaves [cap], dst = ring [R]
  const int8_t* ops;        // [cap]
  int8_t* ring_ops;         // [R]
  const uint8_t* valid;     // [cap] row order
  const uint8_t* overflow;  // [cap] K3: sorted (pre-agg) or row order
  const uint8_t* rep;       // [cap] sorted segment representatives, or null
  const uint8_t* starts;    // [cap] sorted segment starts, or null
  const long long* perm;    // [cap] sorted position -> row, or null
  uint8_t* seg_over;        // [cap + 1] scratch
  uint8_t* mask;            // [cap] scratch: rows to divert, row order
  int* count;               // [1] ring fill
  long long* lost;          // [1] the agg's overflow counter
  int cap;
  int ring;
};

__global__ void __launch_bounds__(1024) agg_spill_kernel(AggSpillArgs a) {
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int per = (a.cap + T - 1) / T;
  const int lo = t * per < a.cap ? t * per : a.cap;
  const int hi = lo + per < a.cap ? lo + per : a.cap;
  const int c0 = a.count[0];
  int total;
  if (a.perm != nullptr) {
    for (int i = lo; i < hi; ++i) a.seg_over[i + 1] = 0;
    if (t == 0) a.seg_over[0] = 0;
    int n_starts = 0;
    for (int i = lo; i < hi; ++i) n_starts += a.starts[i];
    const int base = rw_block_exclusive_scan<RwSum>(n_starts, &total);
    // segment ids count the starts up to and including the position
    int sid = base;
    for (int i = lo; i < hi; ++i) {
      sid += a.starts[i];
      if (a.rep[i] && a.overflow[i]) a.seg_over[sid] = 1;
    }
    __syncthreads();
    sid = base;
    for (int i = lo; i < hi; ++i) {
      sid += a.starts[i];
      const long long row = a.perm[i];
      a.mask[row] = a.valid[row] && a.seg_over[sid];
    }
  } else {
    for (int r = lo; r < hi; ++r) a.mask[r] = a.valid[r] && a.overflow[r];
  }
  __syncthreads();
  int mine = 0;
  for (int r = lo; r < hi; ++r) mine += a.mask[r];
  int rank = rw_block_exclusive_scan<RwSum>(mine, &total);
  for (int r = lo; r < hi; ++r) {
    if (!a.mask[r]) continue;
    const long long pos = static_cast<long long>(c0) + rank;
    ++rank;
    if (pos >= a.ring) continue;
    for (int k = 0; k < a.cols.n; ++k) {
      rw_copy_row(a.cols.dst[k], pos, a.cols.src[k], r, a.cols.width[k]);
    }
    a.ring_ops[pos] = a.ops[r];
  }
  if (t == 0) {
    const long long end = static_cast<long long>(c0) + total;
    a.count[0] = static_cast<int>(end < a.ring ? end : a.ring);
    if (end > a.ring) a.lost[0] += end - a.ring;
  }
}

extern "C" int rw_agg_spill(AggSpillArgs args, void* stream) {
  if (args.cap > 0) {
    agg_spill_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
        args);
  }
  return static_cast<int>(cudaGetLastError());
}
