// Kernel K14: one emission window of the hash join (sm_90a).
//
// Replaces risingwave_tpu/stream/hash_join.py `emit_window` (:850) for a
// pool build side.  The logical emission array of a probe chunk is
// [up-transitions | pairs | self rows | down-transitions]; window w holds
// its positions w * out_cap ... w * out_cap + out_cap - 1.  One thread per
// output row:
//   - decodes its section, and in it the probe row r and the offset j,
//     by a binary search over the inclusive prefix sums (searchsorted
//     side="right", clamped to cap - 1, as the reference);
//   - self rows read the compacted self-row index;
//   - pairs and transitions look up the build row's entry
//     pair_tag(probe_hash[r], j) in the build side's tag table, walking
//     the chain up to min(size + 2, 1024) slots (a lookup never writes the
//     table, so each row's own walk is the reference's vectorized loop);
//     a missing entry drops the row, an exhausted walk adds to
//     probe_bound;
//   - gathers pool_pos at the entry's slot (clipped into the pool), then
//     the probe and build columns, strings as bytes plus lengths;
//   - writes the op (Insert/Delete by the probe row's sign, the up/down
//     codes for transitions) and the valid flag.
// Rows past the end compute the same clamped indices as the reference, so
// every output plane equals the plain version's, valid or not.
//
// Bound: bytes.  Per output row it writes its columns (q8: 13 leaves,
// ~110 B) and reads about as much plus a few random 4-8 B reads of the
// prefix sums, the tag chain and pool_pos.
#include "rw_common.cuh"
#include "rw_join.cuh"

struct JoinEmitArgs {
  JoinCols cols;            // src: probe chunk [cap] or build pool rows
  const int* up_end;        // [cap] inclusive cumsum of up_cnt
  const int* up_cnt;
  const int* pair_end;      // [cap] inclusive cumsum of m
  const int* m;
  const int* self_sel;      // [cap]
  const int* down_end;
  const int* down_cnt;
  const int* U;             // section sizes (device scalars)
  const int* P;
  const int* S;
  const int* total;
  const long long* probe_hash;  // [cap]
  const int* signs;             // [cap]
  const long long* tags;        // [size] build side tag table
  const int* pool_pos;          // [size]
  int8_t* ops;                  // [out_cap] out
  uint8_t* valid;               // [out_cap] out
  long long* probe_bound;       // [1] out, zeroed by the caller
  long long w;
  int out_cap;
  int cap;
  int size;
  int pool;
  int max_iters;
  int up_op;
  int down_op;
};

// searchsorted(end, pos, side="right"): elements <= pos in the sorted end
__device__ __forceinline__ int search_right(const int* end, int n,
                                            long long pos) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (end[mid] <= pos) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ void decode(const int* end, const int* cnt,
                                       int cap, long long pos, int* r,
                                       long long* j) {
  int i = search_right(end, cap, pos);
  if (i > cap - 1) i = cap - 1;
  *r = i;
  *j = pos - (end[i] - cnt[i]);
}

__global__ void join_emit_kernel(JoinEmitArgs a) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= a.out_cap) return;
  const long long U = a.U[0], P = a.P[0], S = a.S[0], total = a.total[0];
  const long long gpos = a.w * a.out_cap + o;
  bool valid_out = gpos < total;
  const bool in_up = valid_out && gpos < U;
  const long long ppos = gpos - U;
  const bool in_pairs = valid_out && gpos >= U && ppos < P;
  const long long spos = ppos - P;
  const bool in_self = valid_out && ppos >= P && spos < S;
  const long long dpos = spos - S;
  const bool in_down = valid_out && spos >= S;

  int ur, pr, dr;
  long long uj, pj, dj;
  decode(a.up_end, a.up_cnt, a.cap, gpos, &ur, &uj);
  decode(a.pair_end, a.m, a.cap, ppos, &pr, &pj);
  decode(a.down_end, a.down_cnt, a.cap, dpos, &dr, &dj);
  const long long sc = spos < 0 ? 0 : (spos > a.cap - 1 ? a.cap - 1 : spos);
  const int sr = a.self_sel[sc];
  const int r = in_up ? ur : (in_pairs ? pr : (in_self ? sr : dr));
  const long long j = in_up ? uj : (in_pairs ? pj : (in_down ? dj : 0));

  const bool need = in_pairs || in_up || in_down;
  int bslot = a.size;
  bool bfound = false;
  if (need) {
    const uint64_t tag = rw_pair_tag(static_cast<uint64_t>(a.probe_hash[r]),
                                     static_cast<int>(j));
    const int mask = a.size - 1;
    const int home = static_cast<int>(tag & static_cast<uint64_t>(mask));
    bool done = false;
    for (int it = 0; it < a.max_iters; ++it) {
      const int c = (home + it) & mask;
      const uint64_t tv = static_cast<uint64_t>(a.tags[c]);
      if (tv == tag) {
        bslot = c;
        bfound = true;
        done = true;
        break;
      }
      if (tv == RW_EMPTY_TAG) {
        done = true;
        break;
      }
    }
    if (!done) {
      atomicAdd(reinterpret_cast<unsigned long long*>(a.probe_bound), 1ull);
    }
  }
  int bpos = a.pool_pos[bslot < a.size - 1 ? bslot : a.size - 1];
  bpos = bpos < 0 ? 0 : (bpos > a.pool - 1 ? a.pool - 1 : bpos);
  valid_out = valid_out && (!need || bfound);

  for (int k = 0; k < a.cols.n; ++k) {
    rw_copy_row(a.cols.dst[k], o, a.cols.src[k],
                a.cols.from_probe[k] ? r : bpos, a.cols.width[k]);
  }
  const int base = a.signs[r] > 0 ? 0 : 1;  // OP_INSERT : OP_DELETE
  a.ops[o] = static_cast<int8_t>(in_up ? a.up_op
                                       : (in_down ? a.down_op : base));
  a.valid[o] = valid_out;
}

extern "C" int rw_join_emit(JoinEmitArgs args, void* stream) {
  if (args.out_cap > 0) {
    const int threads = 256;
    const int blocks = (args.out_cap + threads - 1) / threads;
    join_emit_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}
