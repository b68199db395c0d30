// K20: the over-window's segment scan and flush (sm_90a).
//
// Replaces risingwave_tpu/stream/over_window.py `_segment_starts` (:86),
// `OverWindowExecutor._compute_outputs` (:169) and the gather and row hash
// of `flush` (:302-318).  Before it, K17's key launch (`rw_topn_keys`)
// encodes the ORDER BY keys and hashes the PARTITION BY columns, and three
// stable torch.sorts give the pool's order: order keys, partition hash,
// then validity.  After it, K18's membership launch (`rw_topn_flush_diff`)
// diffs the new rows against the last emitted ones.
//
// Only the first P = min(E, S) sorted positions are emitted (the flush
// takes the first E sorted rows, row S-1 for positions past the pool), and
// every window value at a position is a function of the positions up to
// it, so the scans stop at P.  Per position i (o = order[i]):
//   - part(i) = valid[o] ? hash[o] : ~0; sorted, part is non-decreasing
//     (valid rows first by hash, the invalid rows one sentinel segment), so
//     the segment start is a binary search for the first position of
//     part(i): no scan and no per-partition thread, whatever the skew;
//   - tie(i) = fold of tie * 1000003 ^ key over the order keys (uint64,
//     wrapping); new_val(i) = i == 0 || tie(i) != tie(i-1) || part changes;
//   - scan lanes, each an inclusive (segment-flag, value) scan over [0, P):
//     the rank anchor (max of new_val ? i : 0), the dense rank (sum of
//     new_val), per sum/count/avg call the prefix sum of its argument
//     (int64 wrapping, float64, or float32), per min/max call a running
//     min/max restarted at every segment start.
// The scans are three phases, all of them wide: ow_scan_local scans each
// 1024-position block (warp shuffles, then the warp totals) and writes the
// block's total; ow_scan_carry (one block) scans the block totals into
// exclusive carries; ow_finish adds the carry of its block to each lane it
// reads.  A partition that holds 90% of the pool is just many blocks.
//
// ow_finish, one thread per emitted position e < E (i = min(e, S - 1)):
//   - row_number i - start + 1; rank anchor(i) - start + 1; dense_rank
//     dense(i) - dense(start) + 1;
//   - lag/lead: the argument at i -/+ offset when that position is in the
//     pool and in i's partition, else zero (strings: zero bytes and length);
//   - sum/count/avg: cum(i) - (cum(lo) - v(lo)) with lo = start or
//     max(i - n, start) for ROWS n PRECEDING, as the reference subtracts;
//     avg divides by i - lo + 1 (a DECIMAL truncates toward zero);
//   - min/max: the lane;
// and writes the row into the changelog's insert half and into the new
// emitted rows (buffers of their own), the old emitted row into the delete
// half, the row's liveness, and its hash over the full output row (K1's
// device function, 0 for a dead row).  Thread 0 raises `overflow` to the
// valid rows past E (valid rows sort first: a binary search).  Dead
// positions get every value too, as the reference computes them.
//
// Integer results are exact.  Float sums add in another order than the
// plain version's cumsum: exact when every partial sum is (integers below
// 2^53, dyadic values), else within rounding.
//
// Bound: bytes.  Per scanned position: order, valid, hash and order keys
// read (~17 B + 8 B per key), the sorted key and 8 B per lane written and
// read back; per emitted position the pool row and the old row read, the
// out chunk's two rows and the new row written (~4 x the row width) and
// the lane values at i, lo and start read.
#include "rw_common.cuh"

#define OW_MAX_CALLS 16
#define OW_MAX_LEAVES 16
#define OW_MAX_LANES 18
#define OW_BLOCK 1024

enum {
  OW_ROW_NUMBER = 0, OW_RANK, OW_DENSE_RANK, OW_LAG, OW_LEAD,
  OW_SUM, OW_COUNT, OW_AVG, OW_MIN, OW_MAX
};
// how a value is stored: the argument's and the output's physical type
enum { OW_I8 = 0, OW_I16, OW_I32, OW_I64, OW_F32, OW_F64, OW_STR };
// scan lane operations
enum {
  OW_ADD_I64 = 0, OW_ADD_F64, OW_ADD_F32, OW_MAX_I64, OW_MIN_I64,
  OW_MAX_F64, OW_MIN_F64
};

struct OwLeaf {            // one input column leaf of the output row
  const void* pool;        // [S] slot order
  const void* prev;        // [E] last emitted rows
  void* out;               // [2E] changelog: deletes, then inserts
  void* cur;               // [E] new emitted rows
  int width;               // bytes per row
  int kind;                // RW_KIND_* for the row hash
};

struct OwCall {
  int kind;
  int arg_type;            // OW_* storage type of the argument
  int arg_width;           // bytes per argument row (a string's width)
  int out_type;            // OW_* storage type of the output
  int out_width;           // bytes per output row (a string's width)
  int offset;              // lag/lead distance
  int pre;                 // ROWS pre PRECEDING; -1: from the start
  int lane;                // scan lane (sum/count/avg/min/max)
  int decimal_avg;         // avg truncated toward zero at the input scale
  const void* arg;         // [S] slot order
  const int32_t* arg_lens; // [S] a string argument's lengths
  const void* prev;        // [E]
  const int32_t* prev_lens;
  void* out;               // [2E]
  int32_t* out_lens;
  void* cur;               // [E]
  int32_t* cur_lens;
};

struct OverWindowArgs {
  const int64_t* order;    // [S] sorted slot order
  const uint8_t* valid;    // [S] slot order
  const uint64_t* part;    // [S] partition hash, slot order (0: none)
  const int64_t* okeys;    // [n_order, S] sortable order keys (key ^ 2^63)
  int n_order;
  int n_leaves;
  OwLeaf leaf[OW_MAX_LEAVES];
  int n_calls;
  OwCall call[OW_MAX_CALLS];
  int n_lanes;
  int lane_op[OW_MAX_LANES];
  int lane_flagged[OW_MAX_LANES];  // restarted at segment starts
  int anchor_lane;         // -1 without rank
  int dense_lane;          // -1 without dense_rank
  uint64_t* lane_local;    // [n_lanes, P] block-local inclusive scans
  uint64_t* lane_carry;    // [n_lanes, nb] block totals, then carries
  uint8_t* blk_flag;       // [nb] a segment starts in the block
  int64_t* ps;             // [P] sorted partition key ^ 2^63
  uint64_t* cur_hash;      // [E]
  uint8_t* cur_live;       // [E]
  long long* overflow;     // [1] raised to the valid rows past E
  int S;
  int E;
  int P;
  int nb;
};

static constexpr uint64_t OW_SIGN = 1ull << 63;

__device__ __forceinline__ uint64_t f64_bits(double x) {
  return static_cast<uint64_t>(__double_as_longlong(x));
}
__device__ __forceinline__ double bits_f64(uint64_t u) {
  return __longlong_as_double(static_cast<long long>(u));
}
__device__ __forceinline__ uint64_t f32_bits(float x) {
  return static_cast<uint64_t>(__float_as_uint(x));
}
__device__ __forceinline__ float bits_f32(uint64_t u) {
  return __uint_as_float(static_cast<uint32_t>(u));
}

__device__ __forceinline__ double nan_max(double a, double b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return a > b ? a : b;
}
__device__ __forceinline__ double nan_min(double a, double b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return a < b ? a : b;
}

// op(a, b), a the earlier value
__device__ __forceinline__ uint64_t lane_combine(int op, uint64_t a,
                                                 uint64_t b) {
  switch (op) {
    case OW_ADD_I64: return a + b;
    case OW_ADD_F64: return f64_bits(bits_f64(a) + bits_f64(b));
    case OW_ADD_F32: return f32_bits(bits_f32(a) + bits_f32(b));
    case OW_MAX_I64:
      return static_cast<int64_t>(a) > static_cast<int64_t>(b) ? a : b;
    case OW_MIN_I64:
      return static_cast<int64_t>(a) < static_cast<int64_t>(b) ? a : b;
    case OW_MAX_F64: return f64_bits(nan_max(bits_f64(a), bits_f64(b)));
    default: return f64_bits(nan_min(bits_f64(a), bits_f64(b)));
  }
}

__device__ __forceinline__ uint64_t lane_identity(int op) {
  switch (op) {
    case OW_MAX_I64: return static_cast<uint64_t>(INT64_MIN);
    case OW_MIN_I64: return static_cast<uint64_t>(INT64_MAX);
    case OW_MAX_F64: return f64_bits(-INFINITY);
    case OW_MIN_F64: return f64_bits(INFINITY);
    default: return 0ull;  // +0 of every sum
  }
}

__device__ __forceinline__ int64_t load_int(const void* base, int type,
                                            int64_t i) {
  switch (type) {
    case OW_I8: return static_cast<const int8_t*>(base)[i];
    case OW_I16: return static_cast<const int16_t*>(base)[i];
    case OW_I32: return static_cast<const int32_t*>(base)[i];
    default: return static_cast<const int64_t*>(base)[i];
  }
}

__device__ __forceinline__ double load_real(const void* base, int type,
                                            int64_t i) {
  if (type == OW_F32) return static_cast<const float*>(base)[i];
  if (type == OW_F64) return static_cast<const double*>(base)[i];
  return static_cast<double>(load_int(base, type, i));
}

__device__ __forceinline__ bool is_float(int type) {
  return type == OW_F32 || type == OW_F64;
}

__device__ __forceinline__ uint64_t part_at(const OverWindowArgs& a,
                                            int64_t i) {
  const int64_t o = a.order[i];
  return a.valid[o] ? a.part[o] : ~0ull;
}

__device__ __forceinline__ uint64_t tie_at(const OverWindowArgs& a,
                                           int64_t i) {
  const int64_t o = a.order[i];
  uint64_t t = 0;
  for (int j = 0; j < a.n_order; ++j) {
    const uint64_t k =
        static_cast<uint64_t>(a.okeys[j * static_cast<int64_t>(a.S) + o]) ^
        OW_SIGN;
    t = t * 1000003ull ^ k;
  }
  return t;
}

// The lane value a sum/count/avg/min/max call contributes at position i.
__device__ __forceinline__ uint64_t call_value(const OverWindowArgs& a,
                                               const OwCall& c, int op,
                                               int64_t i) {
  const int64_t o = a.order[i];
  if (c.kind == OW_COUNT) return a.valid[o] ? 1ull : 0ull;
  switch (op) {
    case OW_ADD_I64:
    case OW_MAX_I64:
    case OW_MIN_I64:
      return static_cast<uint64_t>(load_int(c.arg, c.arg_type, o));
    case OW_ADD_F32:
      return f32_bits(static_cast<const float*>(c.arg)[o]);
    default:
      return f64_bits(load_real(c.arg, c.arg_type, o));
  }
}

// Inclusive (flag, value) scan of one 1024-thread block; `sf`/`sv` are
// 32-entry shared scratch.
__device__ __forceinline__ void block_scan(int op, bool& f, uint64_t& v,
                                           int* sf, uint64_t* sv) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const int fo = __shfl_up_sync(0xFFFFFFFFu, static_cast<int>(f), d);
    const uint64_t vo = __shfl_up_sync(0xFFFFFFFFu, v, d);
    if (lane >= d) {
      if (!f) v = lane_combine(op, vo, v);
      f = f || fo;
    }
  }
  if (lane == 31) {
    sf[w] = f;
    sv[w] = v;
  }
  __syncthreads();
  if (w == 0) {
    bool g = sf[lane] != 0;
    uint64_t u = sv[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int go = __shfl_up_sync(0xFFFFFFFFu, static_cast<int>(g), d);
      const uint64_t uo = __shfl_up_sync(0xFFFFFFFFu, u, d);
      if (lane >= d) {
        if (!g) u = lane_combine(op, uo, u);
        g = g || go;
      }
    }
    sf[lane] = g;
    sv[lane] = u;
  }
  __syncthreads();
  if (w > 0) {
    if (!f) v = lane_combine(op, sv[w - 1], v);
    f = f || sf[w - 1];
  }
  __syncthreads();  // the scratch is reused by the next lane
}

__global__ void __launch_bounds__(OW_BLOCK) ow_scan_local(OverWindowArgs a) {
  __shared__ int sf[32];
  __shared__ uint64_t sv[32];
  const int64_t i = blockIdx.x * static_cast<int64_t>(OW_BLOCK) +
                    threadIdx.x;
  const bool in = i < a.P;
  bool is_new = false, new_val = false;
  if (in) {
    const uint64_t p = part_at(a, i);
    a.ps[i] = static_cast<int64_t>(p ^ OW_SIGN);
    is_new = i == 0 || p != part_at(a, i - 1);
    new_val = is_new || (a.n_order > 0 && tie_at(a, i) != tie_at(a, i - 1));
  }
  const int any_new = __syncthreads_or(is_new);
  if (threadIdx.x == 0) a.blk_flag[blockIdx.x] = any_new != 0;
  for (int L = 0; L < a.n_lanes; ++L) {
    const int op = a.lane_op[L];
    bool f = in && a.lane_flagged[L] && is_new;
    uint64_t v = lane_identity(op);
    if (in) {
      if (L == a.anchor_lane) {
        v = new_val ? static_cast<uint64_t>(i) : 0ull;
      } else if (L == a.dense_lane) {
        v = new_val ? 1ull : 0ull;
      } else {
        for (int c = 0; c < a.n_calls; ++c) {
          if (a.call[c].lane == L) v = call_value(a, a.call[c], op, i);
        }
      }
    }
    block_scan(op, f, v, sf, sv);
    if (in) a.lane_local[L * static_cast<int64_t>(a.P) + i] = v;
    if (threadIdx.x == OW_BLOCK - 1) {
      a.lane_carry[L * static_cast<int64_t>(a.nb) + blockIdx.x] = v;
    }
  }
}

// One block: the block totals of every lane into exclusive carries.
__global__ void __launch_bounds__(OW_BLOCK) ow_scan_carry(OverWindowArgs a) {
  __shared__ int sf[32];
  __shared__ uint64_t sv[32];
  __shared__ int tf[OW_BLOCK];
  __shared__ uint64_t tv[OW_BLOCK];
  const int t = threadIdx.x;
  const int per = (a.nb + OW_BLOCK - 1) / OW_BLOCK;
  const int b0 = t * per;
  const int b1 = min(a.nb, b0 + per);
  for (int L = 0; L < a.n_lanes; ++L) {
    const int op = a.lane_op[L];
    uint64_t* tot = a.lane_carry + L * static_cast<int64_t>(a.nb);
    const bool flagged = a.lane_flagged[L] != 0;
    bool f = false;
    uint64_t v = lane_identity(op);
    for (int b = b0; b < b1; ++b) {
      const bool fb = flagged && a.blk_flag[b];
      v = fb ? tot[b] : lane_combine(op, v, tot[b]);
      f = f || fb;
    }
    block_scan(op, f, v, sf, sv);
    tf[t] = f;
    tv[t] = v;
    __syncthreads();
    bool rf = t > 0 && tf[t - 1];
    uint64_t rv = t > 0 ? tv[t - 1] : lane_identity(op);
    for (int b = b0; b < b1; ++b) {
      const uint64_t here = tot[b];
      tot[b] = rv;
      const bool fb = flagged && a.blk_flag[b];
      rv = fb ? here : lane_combine(op, rv, here);
      rf = rf || fb;
    }
    __syncthreads();
  }
}

// The lane's inclusive value at position x; for a flagged lane `start` is
// x's segment start.
__device__ __forceinline__ uint64_t lane_at(const OverWindowArgs& a, int L,
                                            int64_t x, int64_t start) {
  const uint64_t local = a.lane_local[L * static_cast<int64_t>(a.P) + x];
  const int64_t b = x / OW_BLOCK;
  if (b == 0 || (a.lane_flagged[L] && start >= b * OW_BLOCK)) return local;
  return lane_combine(a.lane_op[L],
                      a.lane_carry[L * static_cast<int64_t>(a.nb) + b],
                      local);
}

__device__ __forceinline__ void copy_row(void* dst, int64_t di,
                                         const void* src, int64_t si,
                                         int w) {
  uint8_t* pd = static_cast<uint8_t*>(dst) + di * w;
  const uint8_t* ps = static_cast<const uint8_t*>(src) + si * w;
  switch (w) {
    case 1: *pd = *ps; break;
    case 2: *reinterpret_cast<uint16_t*>(pd) =
                *reinterpret_cast<const uint16_t*>(ps); break;
    case 4: *reinterpret_cast<uint32_t*>(pd) =
                *reinterpret_cast<const uint32_t*>(ps); break;
    case 8: *reinterpret_cast<uint64_t*>(pd) =
                *reinterpret_cast<const uint64_t*>(ps); break;
    default:
      for (int j = 0; j < w; ++j) pd[j] = ps[j];
  }
}

__device__ __forceinline__ void zero_row(void* dst, int64_t di, int w) {
  uint8_t* pd = static_cast<uint8_t*>(dst) + di * w;
  for (int j = 0; j < w; ++j) pd[j] = 0;
}

__device__ __forceinline__ void store_int(void* base, int type, int64_t i,
                                          int64_t v) {
  switch (type) {
    case OW_I8: static_cast<int8_t*>(base)[i] = static_cast<int8_t>(v); break;
    case OW_I16:
      static_cast<int16_t*>(base)[i] = static_cast<int16_t>(v); break;
    case OW_I32:
      static_cast<int32_t*>(base)[i] = static_cast<int32_t>(v); break;
    default: static_cast<int64_t*>(base)[i] = v;
  }
}

// Write a lane-typed value (int64 bits, float64 bits or float32 bits) as
// the call's output type at row i of `base`.
__device__ __forceinline__ void store_value(void* base, int type, int op,
                                            int64_t i, uint64_t v) {
  if (type == OW_F64) {
    static_cast<double*>(base)[i] = op == OW_ADD_F32
        ? static_cast<double>(bits_f32(v)) : bits_f64(v);
  } else if (type == OW_F32) {
    static_cast<float*>(base)[i] = op == OW_ADD_F32
        ? bits_f32(v) : static_cast<float>(bits_f64(v));
  } else {
    store_int(base, type, i, static_cast<int64_t>(v));
  }
}

// K1's hash (rw_common.cuh) of new emitted row e: the input leaves, then
// the window outputs, as the reference hashes the full output row.
__device__ __forceinline__ uint64_t row_hash(const OverWindowArgs& a,
                                             int64_t e) {
  uint64_t st = RW_K1;
  for (int k = 0; k < a.n_leaves; ++k) {
    const OwLeaf& l = a.leaf[k];
    if (l.kind == RW_KIND_STR) {
      const int32_t len = static_cast<const int32_t*>(a.leaf[k + 1].cur)[e];
      st = rw_fold_str(st, static_cast<const uint8_t*>(l.cur) + e * l.width,
                       l.width, len);
      ++k;
    } else if (l.kind == RW_KIND_F32) {
      const float x = static_cast<const float*>(l.cur)[e];
      st = rw_mix64(st ^ (static_cast<uint64_t>(rw_f32_word(x)) * RW_K1));
    } else if (l.kind == RW_KIND_F64) {
      uint32_t hi, lo;
      rw_f64_words(static_cast<const double*>(l.cur)[e], &hi, &lo);
      st = rw_mix64(st ^ (static_cast<uint64_t>(hi) * RW_K1));
      st = rw_mix64(st ^ (static_cast<uint64_t>(lo) * RW_K1));
    } else {
      st = rw_mix64(st ^ (rw_load_word(l.cur, l.width, e) * RW_K1));
    }
  }
  for (int c = 0; c < a.n_calls; ++c) {
    const OwCall& cl = a.call[c];
    if (cl.out_type == OW_STR) {
      st = rw_fold_str(st, static_cast<const uint8_t*>(cl.cur) +
                               e * cl.out_width,
                       cl.out_width, cl.cur_lens[e]);
    } else if (cl.out_type == OW_F32) {
      const float x = static_cast<const float*>(cl.cur)[e];
      st = rw_mix64(st ^ (static_cast<uint64_t>(rw_f32_word(x)) * RW_K1));
    } else if (cl.out_type == OW_F64) {
      uint32_t hi, lo;
      rw_f64_words(static_cast<const double*>(cl.cur)[e], &hi, &lo);
      st = rw_mix64(st ^ (static_cast<uint64_t>(hi) * RW_K1));
      st = rw_mix64(st ^ (static_cast<uint64_t>(lo) * RW_K1));
    } else {
      st = rw_mix64(st ^ (rw_load_word(cl.cur, cl.out_width, e) * RW_K1));
    }
  }
  return rw_hash_finish(st);
}

__global__ void ow_finish(OverWindowArgs a) {
  const int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (e == 0 && a.S > a.E) {
    // valid rows sort first: the valid rows past E are n_valid - E
    int64_t lo = 0, hi = a.S;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (a.valid[a.order[mid]]) lo = mid + 1; else hi = mid;
    }
    const long long beyond = lo > a.E ? lo - a.E : 0;
    if (beyond > *a.overflow) *a.overflow = beyond;
  }
  if (e >= a.E) return;
  const int64_t i = e < a.S ? e : a.S - 1;
  const int64_t o = a.order[i];
  const bool live = a.valid[o] != 0;
  const int64_t E = a.E;
  // the segment start: the first position of ps[i]
  const int64_t key = a.ps[i];
  int64_t lo = 0, hi = i;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a.ps[mid] < key) lo = mid + 1; else hi = mid;
  }
  const int64_t start = lo;

  for (int k = 0; k < a.n_leaves; ++k) {
    const OwLeaf& l = a.leaf[k];
    copy_row(l.cur, e, l.pool, o, l.width);
    copy_row(l.out, E + e, l.pool, o, l.width);
    copy_row(l.out, e, l.prev, e, l.width);
  }
  for (int c = 0; c < a.n_calls; ++c) {
    const OwCall& cl = a.call[c];
    copy_row(cl.out, e, cl.prev, e, cl.out_width);
    if (cl.out_type == OW_STR) cl.out_lens[e] = cl.prev_lens[e];
    int64_t r = 0;
    switch (cl.kind) {
      case OW_ROW_NUMBER: r = i - start + 1; break;
      case OW_RANK:
        r = static_cast<int64_t>(lane_at(a, a.anchor_lane, i, start)) -
            start + 1;
        break;
      case OW_DENSE_RANK:
        r = static_cast<int64_t>(lane_at(a, a.dense_lane, i, start) -
                                 lane_at(a, a.dense_lane, start, start)) + 1;
        break;
      case OW_LAG:
      case OW_LEAD: {
        const int64_t src = cl.kind == OW_LAG ? i - cl.offset : i + cl.offset;
        const bool same = src >= 0 && src < a.S &&
                          part_at(a, src) == part_at(a, i);
        if (same) {
          const int64_t so = a.order[src];
          copy_row(cl.cur, e, cl.arg, so, cl.out_width);
          copy_row(cl.out, E + e, cl.arg, so, cl.out_width);
        } else {
          zero_row(cl.cur, e, cl.out_width);
          zero_row(cl.out, E + e, cl.out_width);
        }
        if (cl.out_type == OW_STR) {
          const int32_t len = same ? cl.arg_lens[a.order[src]] : 0;
          cl.cur_lens[e] = len;
          cl.out_lens[E + e] = len;
        }
        continue;
      }
      case OW_SUM:
      case OW_COUNT:
      case OW_AVG: {
        const int op = a.lane_op[cl.lane];
        const int64_t lo_i =
            cl.pre >= 0 ? (i - cl.pre > start ? i - cl.pre : start) : start;
        const uint64_t cum = lane_at(a, cl.lane, i, start);
        const uint64_t cum_lo = lane_at(a, cl.lane, lo_i, start);
        const uint64_t v_lo = call_value(a, cl, op, lo_i);
        const int64_t n = i - lo_i + 1;
        uint64_t agg;
        if (op == OW_ADD_F64) {
          const double before = bits_f64(cum_lo) - bits_f64(v_lo);
          const double s = bits_f64(cum) - before;
          agg = f64_bits(cl.kind == OW_AVG ? s / static_cast<double>(n) : s);
        } else if (op == OW_ADD_F32) {
          const float before = bits_f32(cum_lo) - bits_f32(v_lo);
          agg = f32_bits(bits_f32(cum) - before);
        } else {
          agg = cum - (cum_lo - v_lo);
          if (cl.kind == OW_AVG) {  // a DECIMAL: truncate toward zero
            const int64_t s = static_cast<int64_t>(agg);
            const int64_t m = (s < 0 ? -s : s) / n;
            agg = static_cast<uint64_t>(s < 0 ? -m : (s > 0 ? m : 0));
          }
        }
        store_value(cl.cur, cl.out_type, op, e, agg);
        store_value(cl.out, cl.out_type, op, E + e, agg);
        continue;
      }
      default: {  // min / max
        const int op = a.lane_op[cl.lane];
        const uint64_t v = lane_at(a, cl.lane, i, start);
        store_value(cl.cur, cl.out_type, op, e, v);
        store_value(cl.out, cl.out_type, op, E + e, v);
        continue;
      }
    }
    store_int(cl.cur, cl.out_type, e, r);
    store_int(cl.out, cl.out_type, E + e, r);
  }
  a.cur_live[e] = live;
  a.cur_hash[e] = live ? row_hash(a, e) : 0ull;
}

extern "C" int rw_over_window(OverWindowArgs args, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (args.P > 0) {
    ow_scan_local<<<args.nb, OW_BLOCK, 0, s>>>(args);
    if (args.n_lanes > 0) ow_scan_carry<<<1, OW_BLOCK, 0, s>>>(args);
  }
  if (args.E > 0) {
    const int threads = 256;
    ow_finish<<<(args.E + threads - 1) / threads, threads, 0, s>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}
