// Kernel K14: one emission window of the hash join (sm_90a).
//
// Replaces risingwave_tpu/stream/hash_join.py `emit_window` (:850) for a
// pool or a dense build side and every join type.  The logical emission
// array of a probe chunk is [up-transitions | pairs | self rows |
// down-transitions]; window w holds its positions w * out_cap ...
// w * out_cap + out_cap - 1.  One thread per output row:
//   - decodes its section, and in it the probe row r and the offset j,
//     by a binary search over the inclusive prefix sums (searchsorted
//     side="right", clamped to cap - 1, as the reference);
//   - self rows read the compacted self-row index;
//   - over a POOL build, pairs and transitions look up the build row's
//     entry pair_tag(probe_hash[r], j) in the build side's tag table,
//     walking the chain up to min(size + 2, 1024) slots (a lookup never
//     writes the table, so each row's own walk is the reference's
//     vectorized loop); a missing entry drops the row, an exhausted walk
//     adds to probe_bound; pool_pos at the entry's slot (clipped into the
//     pool) is the build row;
//   - over a DENSE build, the build row is entry bidx of bucket slots[r]:
//     the reference's `rank_to_idx[r, clip(j, 0, B - 1)]`, the stable
//     argsort of the bucket's free flags, found in-thread as the j-th
//     occupied position, or past the `live[r]` occupied ones the
//     (j - live)-th free one (a probe row with no live rows reads its
//     bucket as all free: position j);
//   - gathers the probe and build columns, strings as bytes plus lengths;
//     an output null plane ORs the pad flag in: probe-side columns are
//     NULL on transition rows, build-side columns on self rows (each only
//     where the other side is preserved; the wrapper lists those planes);
//     semi and anti joins list the preserved side's columns only;
//   - writes the op (Insert/Delete by the probe row's sign, the join
//     type's up/down codes for transitions) and the valid flag.
// Rows past the end compute the same clamped indices as the reference, so
// every output plane equals the plain version's, valid or not.
//
// Bound: bytes.  Per output row it writes its columns (q8: 13 leaves,
// ~110 B) and reads about as much plus a few random 4-8 B reads of the
// prefix sums, the tag chain and pool_pos, or of the bucket's occupancy
// bytes (at most B) over a dense build.
#include "rw_common.cuh"
#include "rw_join.cuh"

struct JoinEmitArgs {
  JoinCols cols;            // src: probe chunk [cap] or build pool rows
  const int* up_end;        // [cap] inclusive cumsum of up_cnt
  const int* up_cnt;
  const int* pair_end;      // [cap] inclusive cumsum of m
  const int* m;             // [cap] pairs per probe row (0: semi/anti)
  const int* self_sel;      // [cap]
  const int* down_end;
  const int* down_cnt;
  const int* U;             // section sizes (device scalars)
  const int* P;
  const int* S;
  const int* total;
  const long long* probe_hash;  // [cap]
  const int* signs;             // [cap]
  const long long* tags;        // [size] pool build: tag table
  const int* pool_pos;          // [size] pool build
  const uint8_t* occupied;      // [size * B] dense build
  const int* slots;             // [cap] dense build: clamped key slots
  const int* live;              // [cap] dense build: live rows of the key
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
  int dense;
  int B;
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

  const bool in_trans = in_up || in_down;
  const bool need = !a.dense && (in_pairs || in_trans);
  long long brow;
  if (a.dense) {
    const int jc = j < 0 ? 0 : (j > a.B - 1 ? a.B - 1 : static_cast<int>(j));
    const int live = a.live[r];
    const long long base = static_cast<long long>(a.slots[r]) * a.B;
    int bidx = jc;
    if (live > 0) {
      const bool occ_want = jc < live;
      const int k = occ_want ? jc : jc - live;
      int seen = 0;
      for (int b = 0; b < a.B; ++b) {
        if ((a.occupied[base + b] != 0) != occ_want) continue;
        if (seen == k) {
          bidx = b;
          break;
        }
        ++seen;
      }
    }
    brow = base + bidx;
  } else {
    int bslot = a.size;
    bool bfound = false;
    if (need) {
      const uint64_t tag = rw_pair_tag(
          static_cast<uint64_t>(a.probe_hash[r]), static_cast<int>(j));
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
        atomicAdd(reinterpret_cast<unsigned long long*>(a.probe_bound),
                  1ull);
      }
    }
    int bpos = a.pool_pos[bslot < a.size - 1 ? bslot : a.size - 1];
    bpos = bpos < 0 ? 0 : (bpos > a.pool - 1 ? a.pool - 1 : bpos);
    brow = bpos;
    valid_out = valid_out && (!need || bfound);
  }

  for (int k = 0; k < a.cols.n; ++k) {
    const long long src_row = a.cols.from_probe[k] ? r : brow;
    if (a.cols.pad[k] == 0) {
      rw_copy_row(a.cols.dst[k], o, a.cols.src[k], src_row, a.cols.width[k]);
      continue;
    }
    const uint8_t* src = static_cast<const uint8_t*>(a.cols.src[k]);
    const bool flag = a.cols.pad[k] == 1 ? in_trans : in_self;
    static_cast<uint8_t*>(a.cols.dst[k])[o] =
        (src != nullptr && src[src_row] != 0) || flag;
  }
  const int base_op = a.signs[r] > 0 ? 0 : 1;  // OP_INSERT : OP_DELETE
  a.ops[o] = static_cast<int8_t>(in_up ? a.up_op
                                       : (in_down ? a.down_op : base_op));
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
