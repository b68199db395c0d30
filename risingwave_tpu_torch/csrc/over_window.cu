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
// it (lead reads the input only), so the scan stops at P.  Per position i
// (o = order[i]):
//   - part(i) = valid[o] ? hash[o] : ~0 (sorted: the valid rows by hash,
//     the invalid rows one sentinel segment); is_new(i) = i == 0 ||
//     part(i) != part(i-1);
//   - tie(i) = fold of tie * 1000003 ^ key over the order keys (uint64,
//     wrapping); new_val(i) = is_new(i) || tie(i) != tie(i-1);
//   - scan lanes, each an inclusive scan over [0, P), the flagged ones
//     restarted at every segment start: the segment start (max of is_new ?
//     i : 0, the reference's cummax in `_segment_starts`), the rank anchor
//     (max of new_val ? i : 0), the dense rank (count of new_val, flagged),
//     per sum/count/avg call the running sum of its argument (int64
//     wrapping, float64 or float32, flagged), per min/max call a running
//     min/max (flagged).
//
// Two launches:
//   - ow_scan, a grid of OT-position tiles.  Each thread reads its
//     position's partition hash and tie key once (its neighbour's from the
//     tile in shared memory; the tile's first position reads the one
//     before it), and the tile scans every lane with warp shuffles.  The
//     carry into the tile is a decoupled look-back: each tile publishes
//     its lane totals (tile_agg) at once and its inclusive lanes
//     (tile_incl) as soon as it knows them, each behind a fence and a
//     64-bit status word tagged with the call's epoch (a counter of the
//     wrapper's, one per device and stream, with the scratch: no call
//     resets the words) and the tile's "a segment starts here" flag; warp
//     0 reads 32 tiles' words a round and reduces each lane over the tiles
//     after its stop (the nearest inclusive tile; for a flagged lane also
//     the nearest tile with a segment start) in order.  Tiles come by a
//     ticket, so a tile waits only on running tiles; the last block to
//     finish puts the tickets back to 0.  Every lane's inclusive value is
//     written per position (lane_val), so a partition that holds 90% of
//     the pool is just many tiles, and no position searches for its
//     segment start.
//   - ow_finish, each block a tile of FT emitted positions e < E (i =
//     min(e, S - 1), start = the start lane at i), one thread a position:
//       - row_number i - start + 1; rank anchor(i) - start + 1; dense_rank
//         the dense lane at i;
//       - lag/lead: the argument at src = i -/+ offset when src is in the
//         pool and in i's segment (src >= start before i; the start lane
//         at src equals start after i, or the partition hashes where src
//         is past P), else zero; strings move in words;
//       - sum/count/avg: the lane at i, less the lane at lo - 1 for ROWS n
//         PRECEDING (lo = max(i - n, start) > start); avg divides by
//         i - lo + 1 (a DECIMAL truncates toward zero);
//       - min/max: the lane;
//     written into the changelog's insert half and the new emitted rows,
//     and the row's hash over the full output row (K1's fold, 0 for a dead
//     row): the input leaves from the pool row (strings folded in 8-byte
//     words where the row is aligned), the outputs from the values the
//     thread holds.  Then the block moves its rows plane by plane in words
//     (rw_rowcopy.cuh's gather form): the old emitted rows into the delete
//     half as a contiguous copy, the pool rows at order[i], one gather
//     written twice, into the insert half and the new emitted rows
//     (buffers of their own).  Thread 0 raises `overflow` to the valid
//     rows past E (valid rows sort first: one binary search a call).  Dead
//     positions get every value too, as the reference computes them.
//
// Integer results are exact.  Float sums add in another order than the
// plain version's cumsum: exact when every partial sum is (integers below
// 2^53, dyadic values), else within rounding.
//
// Bound: bytes.  Per scanned position: order, valid, hash, order keys and
// arguments read; per emitted position the pool row and the old row read,
// the out chunk's two rows and the new row written, the hash and liveness
// (the lanes are written and read once more).
#include "rw_common.cuh"
#include "rw_rowcopy.cuh"

#define OW_MAX_CALLS 16
#define OW_MAX_LEAVES 16
#define OW_MAX_LANES 19

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
  int start_lane;          // max of is_new ? i : 0
  int anchor_lane;         // -1 without rank
  int dense_lane;          // -1 without dense_rank
  uint64_t* lane_val;      // [n_lanes, P] inclusive lane values
  unsigned long long* status;  // [n_tiles] look-back words, persistent
  uint64_t* tile_agg;      // [n_tiles, OW_MAX_LANES] a tile's lane totals
  uint64_t* tile_incl;     // [n_tiles, OW_MAX_LANES] its inclusive lanes
  int* ctl;                // [2] tile and finish tickets, rest at 0
  unsigned long long epoch;  // this call's tag of the status words
  uint64_t* cur_hash;      // [E]
  uint8_t* cur_live;       // [E]
  long long* overflow;     // [1] raised to the valid rows past E
  int S;
  int E;
  int P;
  int n_tiles;
};

static constexpr int OT = 512;  // ow_scan: positions a tile
static constexpr int FT = 256;  // ow_finish: emitted positions a block

// status word: epoch << 34 | state << 32 | a segment starts in the tile
#define OW_AGG 1ull     // tile_agg is published
#define OW_PREFIX 2ull  // tile_incl is published

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

__device__ __forceinline__ uint64_t part_of(const OverWindowArgs& a,
                                            int64_t o) {
  return a.valid[o] ? a.part[o] : ~0ull;
}

__device__ __forceinline__ uint64_t tie_of(const OverWindowArgs& a,
                                           int64_t o) {
  uint64_t t = 0;
  for (int j = 0; j < a.n_order; ++j) {
    const uint64_t k =
        static_cast<uint64_t>(a.okeys[j * static_cast<int64_t>(a.S) + o]) ^
        OW_SIGN;
    t = t * 1000003ull ^ k;
  }
  return t;
}

// The lane value a sum/count/avg/min/max call contributes at slot o.
__device__ __forceinline__ uint64_t call_value(const OverWindowArgs& a,
                                               const OwCall& c, int op,
                                               int64_t o) {
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

// Inclusive (flag, value) scan of one OT-thread block; `sf`/`sv` are
// 32-entry shared scratch.
__device__ __forceinline__ void block_scan(int op, bool& f, uint64_t& v,
                                           int* sf, uint64_t* sv) {
  constexpr int NW = OT / 32;
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
    bool g = lane < NW ? sf[lane] != 0 : false;
    uint64_t u = lane < NW ? sv[lane] : lane_identity(op);
    for (int d = 1; d < 32; d <<= 1) {
      const int go = __shfl_up_sync(0xFFFFFFFFu, static_cast<int>(g), d);
      const uint64_t uo = __shfl_up_sync(0xFFFFFFFFu, u, d);
      if (lane >= d) {
        if (!g) u = lane_combine(op, uo, u);
        g = g || go;
      }
    }
    if (lane < NW) {
      sf[lane] = g;
      sv[lane] = u;
    }
  }
  __syncthreads();
  if (w > 0) {
    if (!f) v = lane_combine(op, sv[w - 1], v);
    f = f || sf[w - 1];
  }
  __syncthreads();  // the scratch is reused by the next lane
}

__global__ void __launch_bounds__(OT) ow_scan(OverWindowArgs a) {
  __shared__ int s_ticket;
  __shared__ bool s_last;
  __shared__ uint64_t s_part[OT];
  __shared__ uint64_t s_tie[OT];
  __shared__ uint64_t s_before[2];  // part and tie before the tile
  __shared__ unsigned s_new[OT / 32];
  __shared__ int sf[32];
  __shared__ uint64_t sv[32];
  __shared__ uint64_t s_tot[OW_MAX_LANES];
  __shared__ uint64_t s_carry[OW_MAX_LANES];
  __shared__ bool s_have[OW_MAX_LANES];
  __shared__ bool s_done[OW_MAX_LANES];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  if (t == 0) s_ticket = atomicAdd(&a.ctl[0], 1);
  __syncthreads();
  const int tile = s_ticket;
  const int64_t i = static_cast<int64_t>(tile) * OT + t;
  const bool in = i < a.P;
  const int64_t o = in ? a.order[i] : 0;
  uint64_t p = 0, tie = 0;
  if (in) {
    p = part_of(a, o);
    tie = tie_of(a, o);
  }
  s_part[t] = p;
  s_tie[t] = tie;
  if (t == 0 && i > 0) {
    const int64_t ob = a.order[i - 1];
    s_before[0] = part_of(a, ob);
    s_before[1] = tie_of(a, ob);
  }
  __syncthreads();
  const uint64_t p_prev = t > 0 ? s_part[t - 1] : s_before[0];
  const uint64_t tie_prev = t > 0 ? s_tie[t - 1] : s_before[1];
  const bool is_new = in && (i == 0 || p != p_prev);
  const bool new_val = is_new || (in && a.n_order > 0 && tie != tie_prev);

  // seen: a segment starts at or before this position in the tile
  const unsigned m = __ballot_sync(0xFFFFFFFFu, is_new);
  if (lane == 0) s_new[w] = m;
  __syncthreads();
  bool seen = (m & (0xFFFFFFFFu >> (31 - lane))) != 0;
  bool any = false;
  for (int k = 0; k < OT / 32; ++k) {
    if (k < w) seen = seen || s_new[k] != 0;
    any = any || s_new[k] != 0;
  }

  uint64_t val[OW_MAX_LANES];
#pragma unroll
  for (int L = 0; L < OW_MAX_LANES; ++L) {
    if (L < a.n_lanes) {
      const int op = a.lane_op[L];
      bool f = in && a.lane_flagged[L] && is_new;
      uint64_t v = lane_identity(op);
      if (in) {
        if (L == a.start_lane) {
          v = is_new ? static_cast<uint64_t>(i) : 0ull;
        } else if (L == a.anchor_lane) {
          v = new_val ? static_cast<uint64_t>(i) : 0ull;
        } else if (L == a.dense_lane) {
          v = new_val ? 1ull : 0ull;
        } else {
          for (int c = 0; c < a.n_calls; ++c) {
            if (a.call[c].lane == L) v = call_value(a, a.call[c], op, o);
          }
        }
      }
      block_scan(op, f, v, sf, sv);
      val[L] = v;
      if (t == OT - 1) s_tot[L] = v;
    }
  }
  __syncthreads();

  // the carry into the tile by decoupled look-back (warp 0): each round
  // reads the status words of 32 tiles before it, one a thread, and
  // combines, lane by lane, the tiles after the nearest one that stops the
  // lane (its inclusive lanes published; for a flagged lane, or a segment
  // start in it) by an ordered warp reduction
  if (w == 0) {
    const unsigned long long tag = a.epoch << 34;
    const unsigned long long fl = any ? 1ull : 0ull;
    volatile unsigned long long* status = a.status;
    const int64_t row = static_cast<int64_t>(tile) * OW_MAX_LANES + lane;
    if (lane < a.n_lanes) {
      a.tile_agg[row] = s_tot[lane];
      if (tile == 0) a.tile_incl[row] = s_tot[lane];
      s_have[lane] = false;
      s_done[lane] = false;
    }
    __threadfence();
    __syncwarp();
    if (lane == 0) {
      status[tile] = tag | ((tile == 0 ? OW_PREFIX : OW_AGG) << 32) | fl;
    }
    if (tile > 0) {
      int pos = tile - 1;
      while (true) {
        const int idx = pos - lane;  // lane 0 the nearest
        unsigned long long sw = tag | (OW_PREFIX << 32);
        if (idx >= 0) {
          do {
            sw = status[idx];
          } while ((sw >> 34) != a.epoch);
        }
        __threadfence();
        const bool prefix = ((sw >> 32) & OW_PREFIX) != 0;
        const unsigned s_all = __ballot_sync(0xFFFFFFFFu, prefix);
        const unsigned s_fl =
            __ballot_sync(0xFFFFFFFFu, prefix || (sw & 1ull) != 0);
        const int stop_all = s_all ? __ffs(s_all) - 1 : 32;
        const int stop_fl = s_fl ? __ffs(s_fl) - 1 : 32;
        bool all_done = true;
        for (int L = 0; L < a.n_lanes; ++L) {
          if (s_done[L]) continue;
          const int op = a.lane_op[L];
          const int stop = a.lane_flagged[L] ? stop_fl : stop_all;
          bool has = lane <= stop && idx >= 0;
          uint64_t x = 0;
          if (has) {
            const int64_t at = static_cast<int64_t>(idx) * OW_MAX_LANES + L;
            x = lane == stop && prefix
                ? static_cast<const volatile uint64_t*>(a.tile_incl)[at]
                : static_cast<const volatile uint64_t*>(a.tile_agg)[at];
          }
          for (int d = 1; d < 32; d <<= 1) {  // earlier tiles first
            const uint64_t y = __shfl_down_sync(0xFFFFFFFFu, x, d);
            const int hy = __shfl_down_sync(0xFFFFFFFFu,
                                            static_cast<int>(has), d);
            if (lane + d < 32 && hy) {
              x = has ? lane_combine(op, y, x) : y;
              has = true;
            }
          }
          if (lane == 0) {
            if (has) {
              s_carry[L] = s_have[L] ? lane_combine(op, x, s_carry[L]) : x;
              s_have[L] = true;
            }
            s_done[L] = stop < 32;
          }
          __syncwarp();
          all_done = all_done && stop < 32;
        }
        if (all_done) break;
        pos -= 32;
      }
      if (lane < a.n_lanes) {
        a.tile_incl[row] = a.lane_flagged[lane] && any
            ? s_tot[lane]
            : lane_combine(a.lane_op[lane], s_carry[lane], s_tot[lane]);
      }
      __threadfence();
      __syncwarp();
      if (lane == 0) status[tile] = tag | (OW_PREFIX << 32) | fl;
    }
  }
  __syncthreads();
  if (in) {
#pragma unroll
    for (int L = 0; L < OW_MAX_LANES; ++L) {
      if (L < a.n_lanes) {
        uint64_t v = val[L];
        if (tile > 0 && !(a.lane_flagged[L] && seen)) {
          v = lane_combine(a.lane_op[L], s_carry[L], v);
        }
        a.lane_val[L * static_cast<int64_t>(a.P) + i] = v;
      }
    }
  }

  // the last block to finish puts the tickets back
  __syncthreads();
  if (t == 0) {
    __threadfence();
    s_last = atomicAdd(&a.ctl[1], 1) == a.n_tiles - 1;
  }
  __syncthreads();
  if (s_last && t == 0) {
    a.ctl[0] = 0;
    a.ctl[1] = 0;
  }
}

__device__ __forceinline__ uint64_t lane_at(const OverWindowArgs& a, int L,
                                            int64_t x) {
  return a.lane_val[L * static_cast<int64_t>(a.P) + x];
}

// Fold one output value, stored as `bits` (zero-extended) of `type`, into
// the row hash as K1 folds the stored column.
__device__ __forceinline__ uint64_t fold_value(uint64_t st, int type,
                                               uint64_t bits) {
  if (type == OW_F32) {
    const float x = __uint_as_float(static_cast<uint32_t>(bits));
    return rw_mix64(st ^ (static_cast<uint64_t>(rw_f32_word(x)) * RW_K1));
  }
  if (type == OW_F64) {
    uint32_t hi, lo;
    rw_f64_words(bits_f64(bits), &hi, &lo);
    st = rw_mix64(st ^ (static_cast<uint64_t>(hi) * RW_K1));
    return rw_mix64(st ^ (static_cast<uint64_t>(lo) * RW_K1));
  }
  return rw_mix64(st ^ (bits * RW_K1));
}

// The stored bits (zero-extended) of an integer of `type`.
__device__ __forceinline__ uint64_t int_bits(int type, int64_t v) {
  switch (type) {
    case OW_I8: return static_cast<uint8_t>(v);
    case OW_I16: return static_cast<uint16_t>(v);
    case OW_I32: return static_cast<uint32_t>(v);
    default: return static_cast<uint64_t>(v);
  }
}

// Write a lane-typed value as the call's output at new row e and out row
// E + e; returns its stored bits.
__device__ __forceinline__ uint64_t put_value(const OwCall& cl, int op,
                                              int64_t e, int64_t E,
                                              uint64_t v) {
  store_value(cl.cur, cl.out_type, op, e, v);
  store_value(cl.out, cl.out_type, op, E + e, v);
  if (cl.out_type == OW_F64) {
    return f64_bits(op == OW_ADD_F32 ? static_cast<double>(bits_f32(v))
                                     : bits_f64(v));
  }
  if (cl.out_type == OW_F32) {
    return f32_bits(op == OW_ADD_F32 ? bits_f32(v)
                                     : static_cast<float>(bits_f64(v)));
  }
  return int_bits(cl.out_type, static_cast<int64_t>(v));
}

__device__ __forceinline__ uint64_t put_int(const OwCall& cl, int64_t e,
                                            int64_t E, int64_t r) {
  store_int(cl.cur, cl.out_type, e, r);
  store_int(cl.out, cl.out_type, E + e, r);
  return int_bits(cl.out_type, r);
}

// A fixed-width value of `w` bytes from its zero-extended bits.
__device__ __forceinline__ void put_raw(void* base, int w, int64_t i,
                                        uint64_t bits) {
  switch (w) {
    case 1: static_cast<uint8_t*>(base)[i] = static_cast<uint8_t>(bits); break;
    case 2:
      static_cast<uint16_t*>(base)[i] = static_cast<uint16_t>(bits); break;
    case 4:
      static_cast<uint32_t*>(base)[i] = static_cast<uint32_t>(bits); break;
    default: static_cast<uint64_t*>(base)[i] = bits;
  }
}

__global__ void __launch_bounds__(FT) ow_finish(OverWindowArgs a) {
  __shared__ int64_t s_src[FT];
  const int t = threadIdx.x;
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * FT;
  const int64_t e = e0 + t;
  const int64_t E = a.E;
  if (blockIdx.x == 0 && t == 0 && a.S > a.E) {
    // valid rows sort first: the valid rows past E are n_valid - E
    int64_t lo = 0, hi = a.S;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (a.valid[a.order[mid]]) lo = mid + 1; else hi = mid;
    }
    const long long beyond = lo > a.E ? lo - a.E : 0;
    if (beyond > *a.overflow) *a.overflow = beyond;
  }
  if (e < E) {
    const int64_t i = e < a.S ? e : a.S - 1;
    const int64_t o = a.order[i];
    s_src[t] = o;
    const bool live = a.valid[o] != 0;
    const int64_t start = static_cast<int64_t>(lane_at(a, a.start_lane, i));
    uint64_t st = RW_K1;
    if (live) {  // the input leaves, from the pool row
      for (int k = 0; k < a.n_leaves; ++k) {
        const OwLeaf& l = a.leaf[k];
        if (l.kind == RW_KIND_STR) {
          const int32_t len =
              static_cast<const int32_t*>(a.leaf[k + 1].pool)[o];
          st = rw_fold_str_words(
              st, static_cast<const uint8_t*>(l.pool) + o * l.width, l.width,
              len);
          ++k;
        } else if (l.kind == RW_KIND_F32) {
          st = fold_value(st, OW_F32,
                          f32_bits(static_cast<const float*>(l.pool)[o]));
        } else if (l.kind == RW_KIND_F64) {
          st = fold_value(st, OW_F64,
                          f64_bits(static_cast<const double*>(l.pool)[o]));
        } else {
          st = rw_mix64(st ^ (rw_load_word(l.pool, l.width, o) * RW_K1));
        }
      }
    }
    for (int c = 0; c < a.n_calls; ++c) {
      const OwCall& cl = a.call[c];
      switch (cl.kind) {
        case OW_ROW_NUMBER:
          st = fold_value(st, cl.out_type, put_int(cl, e, E, i - start + 1));
          break;
        case OW_RANK:
          st = fold_value(st, cl.out_type, put_int(
              cl, e, E,
              static_cast<int64_t>(lane_at(a, a.anchor_lane, i)) - start + 1));
          break;
        case OW_DENSE_RANK:
          st = fold_value(st, cl.out_type, put_int(
              cl, e, E, static_cast<int64_t>(lane_at(a, a.dense_lane, i))));
          break;
        case OW_LAG:
        case OW_LEAD: {
          const int64_t src =
              cl.kind == OW_LAG ? i - cl.offset : i + cl.offset;
          bool same = src >= 0 && src < a.S;
          if (same && src < i) {
            same = src >= start;
          } else if (same && src > i) {
            same = src < a.P
                ? static_cast<int64_t>(lane_at(a, a.start_lane, src)) == start
                : part_of(a, a.order[src]) == part_of(a, o);
          }
          const int64_t so = same ? a.order[src] : 0;
          if (cl.out_type == OW_STR) {
            const int w = cl.out_width;
            uint8_t* cur = static_cast<uint8_t*>(cl.cur) + e * w;
            rw_row_words(same ? static_cast<const uint8_t*>(cl.arg) + so * w
                              : nullptr,
                         cur, static_cast<uint8_t*>(cl.out) + (E + e) * w, w);
            const int32_t len = same ? cl.arg_lens[so] : 0;
            cl.cur_lens[e] = len;
            cl.out_lens[E + e] = len;
            st = rw_fold_str_words(st, cur, w, len);
          } else {
            const uint64_t bits =
                same ? rw_load_word(cl.arg, cl.out_width, so) : 0ull;
            put_raw(cl.cur, cl.out_width, e, bits);
            put_raw(cl.out, cl.out_width, E + e, bits);
            st = fold_value(st, cl.out_type, bits);
          }
          break;
        }
        case OW_SUM:
        case OW_COUNT:
        case OW_AVG: {
          const int op = a.lane_op[cl.lane];
          const int64_t lo_i =
              cl.pre >= 0 ? (i - cl.pre > start ? i - cl.pre : start) : start;
          const uint64_t cum = lane_at(a, cl.lane, i);
          const bool cut = lo_i > start;
          const uint64_t before = cut ? lane_at(a, cl.lane, lo_i - 1) : 0ull;
          const int64_t n = i - lo_i + 1;
          uint64_t agg;
          if (op == OW_ADD_F64) {
            const double s = cut ? bits_f64(cum) - bits_f64(before)
                                 : bits_f64(cum);
            agg = f64_bits(cl.kind == OW_AVG ? s / static_cast<double>(n) : s);
          } else if (op == OW_ADD_F32) {
            agg = cut ? f32_bits(bits_f32(cum) - bits_f32(before)) : cum;
          } else {
            agg = cum - before;
            if (cl.kind == OW_AVG) {  // a DECIMAL: truncate toward zero
              const int64_t s = static_cast<int64_t>(agg);
              const int64_t m = (s < 0 ? -s : s) / n;
              agg = static_cast<uint64_t>(s < 0 ? -m : (s > 0 ? m : 0));
            }
          }
          st = fold_value(st, cl.out_type, put_value(cl, op, e, E, agg));
          break;
        }
        default: {  // min / max
          const int op = a.lane_op[cl.lane];
          st = fold_value(st, cl.out_type,
                          put_value(cl, op, e, E, lane_at(a, cl.lane, i)));
        }
      }
    }
    a.cur_live[e] = live;
    a.cur_hash[e] = live ? rw_hash_finish(st) : 0ull;
  }
  __syncthreads();

  // the rows, plane by plane in words
  const int n = static_cast<int>(E - e0 < FT ? E - e0 : FT);
  const int64_t* src = s_src;
  for (int k = 0; k < a.n_leaves; ++k) {
    const OwLeaf& l = a.leaf[k];
    const int w = l.width;
    uint8_t* out = static_cast<uint8_t*>(l.out);
    rw_gather_plane(static_cast<const uint8_t*>(l.prev) + e0 * w,
                    out + e0 * w, nullptr, w, n, [](int r) { return r; }, t,
                    FT);
    rw_gather_plane(l.pool, out + (E + e0) * w,
                    static_cast<uint8_t*>(l.cur) + e0 * w, w, n,
                    [src](int r) { return src[r]; }, t, FT);
  }
  for (int c = 0; c < a.n_calls; ++c) {
    const OwCall& cl = a.call[c];
    const int w = cl.out_width;
    rw_gather_plane(static_cast<const uint8_t*>(cl.prev) + e0 * w,
                    static_cast<uint8_t*>(cl.out) + e0 * w, nullptr, w, n,
                    [](int r) { return r; }, t, FT);
    if (cl.out_type == OW_STR) {
      rw_gather_plane(cl.prev_lens + e0, cl.out_lens + e0, nullptr, 4, n,
                      [](int r) { return r; }, t, FT);
    }
  }
}

extern "C" int rw_over_window(OverWindowArgs args, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (args.P > 0) {
    if (args.n_tiles != (args.P + OT - 1) / OT) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    ow_scan<<<args.n_tiles, OT, 0, s>>>(args);
  }
  if (args.E > 0) {
    ow_finish<<<(args.E + FT - 1) / FT, FT, 0, s>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}
