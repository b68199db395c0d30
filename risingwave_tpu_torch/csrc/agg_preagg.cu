// Kernel K5: chunk-local pre-aggregation of hash-sorted rows (sm_90a).
//
// Replaces the accelerator branch of risingwave_tpu/stream/hash_agg.py
// `HashAggExecutor.apply` (hash_agg.py:394-436, per-prim segment reduce
// :613-641, row count :639-642) with the segment primitives of
// risingwave_tpu/common/compact.py:46-110.  The wrapper sorts the chunk
// by key hash (torch.sort, stable, on h ^ 2^63 so the signed order is the
// unsigned one; invalid rows carry INT64_MAX and sort last).  Given the
// sorted keys and the permutation, this kernel:
//   1. gathers the key columns into sorted order, restores the sorted
//      hashes and marks segment starts: the hash differs OR any key column
//      differs (NULL == NULL, payload ignored under a null), so colliding
//      distinct keys stay apart.  A string key arrives as two leaves under
//      its null plane, its [n, w] bytes and its int32 lengths, and both
//      compare byte for byte, the padding past the length included, as
//      the reference's `_keys_equal` compares a StrCol;
//   2. reduces, per segment, the valid-row count, the changelog signs and
//      every primitive's lifted contribution (add / min / max, read
//      through the permutation in chunk order), and writes the segment's
//      result at its END row and the identity elsewhere (0 for counts and
//      sums, the primitive's init for min and max);
//   3. marks the representatives: END rows that are valid.
//
// One launch, a grid of tiles of PA_TILE rows, one block each.  A row
// compares with row i - 1 through global memory (sorted keys and the chunk's
// key columns through perm), so a tile marks its starts on its own.  Every
// quantity is scanned at once: each thread holds PA_ITEMS consecutive rows
// and the (has-start, rows, signs, prim...) tuple of each, reduces them,
// and the block runs one segmented scan of those tuples (warp shuffles,
// then the warps' totals through shared memory).  A segment that crosses
// tile edges takes its carry by decoupled look-back: each tile publishes
// its aggregate at once (and its inclusive prefix as soon as it is known;
// a tile that holds a segment start knows it at once: the aggregate from
// its last start), and a tile whose first row is not a start has warp 0
// read its predecessors' words 32 at a time, combining aggregates back to
// the nearest tile with a prefix or a start.  So one segment over the
// whole chunk (the pane shape: 99% of its rows on one auction) costs a few
// rounds of 32 words, not a walk over every tile's latency.  The status
// words carry the call's epoch (a counter of the wrapper's, one per device
// and stream, with the scratch), so no call resets them.  Tiles wait only
// on tiles of lower index, which are scheduled first.
//
// Integer results are exact (int64 sums wrap like the reference's
// cumsum differences; int32 results keep the low 32 bits, as the int32
// cumsum does).  float64 sums are reduced in another order than the plain
// version's cumsum difference and may differ in the last bits.
//
// Bound: bytes (per row: sorted key 8 B, perm 8 B, key columns, valid 1 B,
// sign 4 B, 8 B per primitive read; sorted keys, hash 8 B, rep 1 B, starts
// 1 B and 8 B per reduced quantity written).  What the kernel spends is the
// dependent reads of a row (perm, then its keys, flags and values) and the
// look-back; every tile runs at once up to the card's ~2,000 resident
// blocks (a q5-sharded lane's 163,840 rows are 320 tiles).
#include "rw_common.cuh"

#define PA_MAX_PRIMS 8
#define PA_MAXQ (2 + PA_MAX_PRIMS)

enum { PA_ADD = 0, PA_MIN = 1, PA_MAX = 2 };
enum { PA_I64 = 0, PA_I32 = 1, PA_F64 = 2 };

struct PreaggArgs {
  RwCols keys;                // in_data: chunk keys; st_data: sorted out
  const long long* sort_key;  // [n] sorted: h ^ 2^63, INT64_MAX if invalid
  const long long* perm;      // [n] chunk row of each sorted row
  const uint8_t* valid;       // [n] chunk order
  const int* signs;           // [n] chunk order
  uint8_t* starts;            // [n] out: segment-start flags
  long long* s_hash;          // [n] out: sorted hashes
  uint8_t* rep;               // [n] out: representative rows
  long long* seg_rows;        // [n] out: valid rows per segment (at END)
  long long* seg_signs;       // [n] out: sign sum per segment (at END)
  int n_prims;
  int mode[PA_MAX_PRIMS];
  int dtype[PA_MAX_PRIMS];
  const void* value[PA_MAX_PRIMS];  // [n] chunk order lifted contributions
  void* seg[PA_MAX_PRIMS];          // [n] out: segment result at END rows
  long long init_i[PA_MAX_PRIMS];
  double init_f[PA_MAX_PRIMS];
  int n;
  unsigned long long* status;  // [tiles] look-back words, persistent
  long long* carry;            // [tiles * 2 * PA_MAXQ] look-back values
  unsigned long long epoch;    // this call's tag of the status words
};

constexpr int PA_THREADS = 256;
constexpr int PA_ITEMS = 2;
// rows a tile: the wrapper's `_PREAGG_TILE` sizes the look-back scratch
constexpr int PA_TILE = PA_THREADS * PA_ITEMS;
constexpr int PA_WARPS = PA_THREADS / 32;

// status word: epoch << 8 | has-start << 2 | state
#define PA_AGG 1ull     // the tile's aggregate is published
#define PA_PREFIX 2ull  // its inclusive prefix is published
#define PA_FLAG 4ull    // the tile holds a segment start

// Row a and row b of one input column are equal (byte-wise; read-only
// loads, which the compiler may issue ahead of the kernel's stores).
__device__ __forceinline__ bool rows_equal(const void* base, int w,
                                           long long a, long long b) {
  const uint8_t* pa = static_cast<const uint8_t*>(base) + a * w;
  const uint8_t* pb = static_cast<const uint8_t*>(base) + b * w;
  switch (w) {
    case 1: return __ldg(pa) == __ldg(pb);
    case 2: return __ldg(reinterpret_cast<const unsigned short*>(pa)) ==
                   __ldg(reinterpret_cast<const unsigned short*>(pb));
    case 4: return __ldg(reinterpret_cast<const unsigned int*>(pa)) ==
                   __ldg(reinterpret_cast<const unsigned int*>(pb));
    case 8: return __ldg(reinterpret_cast<const unsigned long long*>(pa)) ==
                   __ldg(reinterpret_cast<const unsigned long long*>(pb));
    default:
      for (int j = 0; j < w; ++j) {
        if (__ldg(pa + j) != __ldg(pb + j)) return false;
      }
      return true;
  }
}

// Sorted row i (sort key ki, chunk row p) starts a segment after sorted
// row i - 1 (kq, q): the hash differs or a key column does.
__device__ __forceinline__ bool starts_after(const PreaggArgs& a, long long i,
                                             long long ki, long long kq,
                                             long long p, long long q) {
  if (i == 0 || ki != kq) return true;
  for (int k = 0; k < a.keys.n; ++k) {
    bool eq;
    if (a.keys.in_null[k] != nullptr) {
      const bool pn = __ldg(a.keys.in_null[k] + p) != 0;
      const bool qn = __ldg(a.keys.in_null[k] + q) != 0;
      eq = (pn && qn) ||
           (!pn && !qn && rows_equal(a.keys.in_data[k], a.keys.width[k], p, q));
    } else {
      eq = rows_equal(a.keys.in_data[k], a.keys.width[k], p, q);
    }
    if (!eq) return true;
  }
  return false;
}

__device__ __forceinline__ bool is_start(const PreaggArgs& a, long long i) {
  if (i == 0) return true;
  return starts_after(a, i, __ldg(a.sort_key + i), __ldg(a.sort_key + i - 1),
                      __ldg(a.perm + i), __ldg(a.perm + i - 1));
}

// A quantity's operation: the sum of int64 (wrapping), min, max, and the
// same over float64 (fmin / fmax); values travel as 64-bit patterns.
enum { OP_ADD_I = 0, OP_MIN_I, OP_MAX_I, OP_ADD_F, OP_MIN_F, OP_MAX_F };

__device__ __forceinline__ long long combine(int op, long long x,
                                             long long y) {
  switch (op) {
    case OP_ADD_I:
      return static_cast<long long>(static_cast<unsigned long long>(x) +
                                    static_cast<unsigned long long>(y));
    case OP_MIN_I: return x < y ? x : y;
    case OP_MAX_I: return x > y ? x : y;
    case OP_ADD_F:
      return __double_as_longlong(__longlong_as_double(x) +
                                  __longlong_as_double(y));
    case OP_MIN_F:
      return __double_as_longlong(
          fmin(__longlong_as_double(x), __longlong_as_double(y)));
    default:
      return __double_as_longlong(
          fmax(__longlong_as_double(x), __longlong_as_double(y)));
  }
}

// A neutral value of each operation (-0.0 for the float sum, NaN for fmin
// and fmax): it fills the rows past n and the lanes with nothing before.
__device__ __forceinline__ long long neutral(int op) {
  switch (op) {
    case OP_ADD_I: return 0;
    case OP_MIN_I: return LLONG_MAX;
    case OP_MAX_I: return LLONG_MIN;
    case OP_ADD_F: return static_cast<long long>(0x8000000000000000ull);
    default: return static_cast<long long>(0x7FF8000000000000ull);
  }
}

// Quantity q's operation: 0 the valid rows, 1 the signs, 2 + p prim p.
__device__ __forceinline__ int op_of(const PreaggArgs& a, int q) {
  if (q < 2) return OP_ADD_I;
  const int p = q - 2;
  return (a.dtype[p] == PA_F64 ? OP_ADD_F : OP_ADD_I) + a.mode[p];
}

__device__ __forceinline__ long long load_q(const PreaggArgs& a, int q,
                                            long long p) {
  if (q == 0) return __ldg(a.valid + p) != 0 ? 1 : 0;
  if (q == 1) return __ldg(a.signs + p);
  const int k = q - 2;
  switch (a.dtype[k]) {
    case PA_I32: return __ldg(static_cast<const int*>(a.value[k]) + p);
    default: return __ldg(static_cast<const long long*>(a.value[k]) + p);
  }
}

// Quantity q's value at sorted row i: the segment's result at its END row,
// the identity elsewhere.
__device__ __forceinline__ void store_q(const PreaggArgs& a, int q,
                                        long long i, bool end, long long v) {
  if (q == 0) {
    a.seg_rows[i] = end ? v : 0;
    return;
  }
  if (q == 1) {
    a.seg_signs[i] = end ? v : 0;
    return;
  }
  const int k = q - 2;
  const bool add = a.mode[k] == PA_ADD;
  switch (a.dtype[k]) {
    case PA_I32:
      static_cast<int*>(a.seg[k])[i] = static_cast<int>(
          end ? v : (add ? 0 : a.init_i[k]));
      break;
    case PA_F64:
      static_cast<double*>(a.seg[k])[i] =
          end ? __longlong_as_double(v) : (add ? 0.0 : a.init_f[k]);
      break;
    default:
      static_cast<long long*>(a.seg[k])[i] =
          end ? v : (add ? 0 : a.init_i[k]);
  }
}

// (fa, x) then (fb, y) in row order: a start in the later part cuts the
// earlier one off.
template <int NQ>
__device__ __forceinline__ void seg_combine(const int* ops, bool fb,
                                            long long (&x)[NQ],
                                            const long long (&y)[NQ]) {
#pragma unroll
  for (int q = 0; q < NQ; ++q) x[q] = fb ? y[q] : combine(ops[q], x[q], y[q]);
}

template <int NQ>
__global__ void __launch_bounds__(PA_THREADS) preagg_kernel(PreaggArgs a) {
  __shared__ uint8_t s_first[PA_THREADS + 1];
  __shared__ bool s_wf[PA_WARPS];
  __shared__ long long s_wv[PA_WARPS][NQ];
  __shared__ long long s_carry[NQ];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long n = a.n;
  const long long tile = blockIdx.x;
  const long long base = tile * PA_TILE;
  int ops[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) ops[q] = op_of(a, q);

  // 1. load the rows, then gather the keys, restore the hashes and mark
  // the starts (every load ahead of the stores)
  const long long i0 = base + static_cast<long long>(t) * PA_ITEMS;
  long long v[PA_ITEMS][NQ], p[PA_ITEMS], sk[PA_ITEMS];
  bool st[PA_ITEMS], ok[PA_ITEMS];
#pragma unroll
  for (int j = 0; j < PA_ITEMS; ++j) {
    ok[j] = i0 + j < n;
    p[j] = ok[j] ? __ldg(a.perm + i0 + j) : 0;
    sk[j] = ok[j] ? __ldg(a.sort_key + i0 + j) : 0;
  }
  // the row before this thread's first (the previous thread's last)
  const bool prev = ok[0] && i0 > 0;
  const long long pp = prev ? __ldg(a.perm + i0 - 1) : 0;
  const long long skp = prev ? __ldg(a.sort_key + i0 - 1) : 0;
#pragma unroll
  for (int j = 0; j < PA_ITEMS; ++j) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      v[j][q] = ok[j] ? load_q(a, q, p[j]) : neutral(ops[q]);
    }
    st[j] = ok[j] && starts_after(a, i0 + j, sk[j], j ? sk[j - 1] : skp,
                                  p[j], j ? p[j - 1] : pp);
  }
#pragma unroll
  for (int j = 0; j < PA_ITEMS; ++j) {
    if (!ok[j]) continue;
    rw_store_row(a.keys, i0 + j, p[j]);
    a.s_hash[i0 + j] = static_cast<long long>(
        static_cast<unsigned long long>(sk[j]) ^ (1ull << 63));
    a.starts[i0 + j] = st[j] ? 1 : 0;
  }
  s_first[t] = st[0];
  if (t == PA_THREADS - 1) {
    const long long nxt = base + PA_TILE;
    s_first[PA_THREADS] = nxt < n ? is_start(a, nxt) : 1;
  }

  // 2. each thread's rows, reduced: (has-start, the part from its last
  // start or from its first row)
  bool tf = false;
  long long acc[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) acc[q] = neutral(ops[q]);
#pragma unroll
  for (int j = 0; j < PA_ITEMS; ++j) {
    if (ok[j]) {
      seg_combine<NQ>(ops, st[j], acc, v[j]);
      tf = tf || st[j];
    }
  }

  // 3. the block's exclusive segmented scan of the threads' tuples
  int incf = tf;
  long long inc[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) inc[q] = acc[q];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int pf = __shfl_up_sync(0xffffffffu, incf, o);
    long long pv[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      pv[q] = __shfl_up_sync(0xffffffffu, inc[q], o);
    }
    if (lane >= o) {
      if (!incf) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) inc[q] = combine(ops[q], pv[q], inc[q]);
      }
      incf = incf | pf;
    }
  }
  if (lane == 31) {
    s_wf[warp] = incf != 0;
#pragma unroll
    for (int q = 0; q < NQ; ++q) s_wv[warp][q] = inc[q];
  }
  // the warp-exclusive part: lane - 1's inclusive one
  int exf = __shfl_up_sync(0xffffffffu, incf, 1);
  long long ex[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) ex[q] = __shfl_up_sync(0xffffffffu, inc[q], 1);
  if (lane == 0) {
    exf = 0;
#pragma unroll
    for (int q = 0; q < NQ; ++q) ex[q] = neutral(ops[q]);
  }
  __syncthreads();
  // the warps before this one, then the lanes before this one
  bool wf = false;
  long long wv[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) wv[q] = neutral(ops[q]);
  for (int u = 0; u < warp; ++u) {
    long long y[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) y[q] = s_wv[u][q];
    seg_combine<NQ>(ops, s_wf[u], wv, y);
    wf = wf || s_wf[u];
  }
  seg_combine<NQ>(ops, exf != 0, wv, ex);
  const bool pre_f = wf || exf;  // a start before this thread in the tile

  // 4. the tile's carry-in, by decoupled look-back (warp 0)
  if (warp == 0) {
    bool tile_f = false;
    long long agg[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) agg[q] = neutral(ops[q]);
    for (int u = 0; u < PA_WARPS; ++u) {
      long long y[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) y[q] = s_wv[u][q];
      seg_combine<NQ>(ops, s_wf[u], agg, y);
      tile_f = tile_f || s_wf[u];
    }
    long long* agg_out = a.carry + (tile * 2) * PA_MAXQ;
    long long* pre_out = agg_out + PA_MAXQ;
    volatile unsigned long long* status = a.status;
    const unsigned long long tag = a.epoch << 8;
    if (lane == 0) {
      // a tile with a start knows its inclusive prefix: the part from its
      // last start
      long long* out = tile_f ? pre_out : agg_out;
#pragma unroll
      for (int q = 0; q < NQ; ++q) out[q] = agg[q];
      __threadfence();
      status[tile] = tag | (tile_f ? PA_FLAG | PA_PREFIX : PA_AGG);
    }
    long long c[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) c[q] = neutral(ops[q]);
    if (!s_first[0]) {  // rows before the tile's first start need a carry
      long long pos = tile - 1;
      while (true) {
        const long long idx = pos - lane;  // lane 0 the nearest
        unsigned long long w = tag | PA_PREFIX | PA_FLAG;
        if (idx >= 0) {
          do {
            w = status[idx];
          } while ((w >> 8) != a.epoch);
        }
        __threadfence();
        const bool stop_here = (w & (PA_PREFIX | PA_FLAG)) != 0;
        const unsigned stops = __ballot_sync(0xffffffffu, stop_here);
        const int stop = stops ? __ffs(stops) - 1 : 32;
        long long y[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) y[q] = neutral(ops[q]);
        if (lane <= stop && idx >= 0) {
          const volatile long long* src =
              a.carry + (idx * 2 + ((w & PA_PREFIX) ? 1 : 0)) * PA_MAXQ;
#pragma unroll
          for (int q = 0; q < NQ; ++q) y[q] = src[q];
        }
        // lanes 0..stop hold no start but the last: their values combine
        // plainly (the operations commute)
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          long long r = y[q];
          for (int o = 16; o > 0; o >>= 1) {
            r = combine(ops[q], r, __shfl_xor_sync(0xffffffffu, r, o));
          }
          c[q] = combine(ops[q], r, c[q]);
        }
        if (stop < 32) break;
        pos -= 32;
      }
      if (lane == 0 && !tile_f) {
        long long y[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) y[q] = c[q];
        seg_combine<NQ>(ops, false, y, agg);
#pragma unroll
        for (int q = 0; q < NQ; ++q) pre_out[q] = y[q];
        __threadfence();
        status[tile] = tag | PA_PREFIX;
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) s_carry[q] = c[q];
    }
  }
  __syncthreads();

  // 5. each row's running value; the segment's result at its END row
  long long run[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) run[q] = s_carry[q];
  seg_combine<NQ>(ops, pre_f, run, wv);
#pragma unroll
  for (int j = 0; j < PA_ITEMS; ++j) {
    if (!ok[j]) continue;
    const long long i = base + static_cast<long long>(t) * PA_ITEMS + j;
    seg_combine<NQ>(ops, st[j], run, v[j]);
    const bool nxt = j + 1 < PA_ITEMS ? (i + 1 >= n || st[j + 1])
                                      : s_first[t + 1] != 0;
    const bool end = i + 1 >= n || nxt;
    a.rep[i] = (end && v[j][0] != 0) ? 1 : 0;  // v[j][0]: the row's valid
#pragma unroll
    for (int q = 0; q < NQ; ++q) store_q(a, q, i, end, run[q]);
  }
}

extern "C" int rw_agg_preagg(PreaggArgs args, void* stream) {
  if (args.n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (args.n + PA_TILE - 1) / PA_TILE;
  switch (args.n_prims) {
    case 0: preagg_kernel<2><<<tiles, PA_THREADS, 0, s>>>(args); break;
    case 1: preagg_kernel<3><<<tiles, PA_THREADS, 0, s>>>(args); break;
    case 2: preagg_kernel<4><<<tiles, PA_THREADS, 0, s>>>(args); break;
    case 3: preagg_kernel<5><<<tiles, PA_THREADS, 0, s>>>(args); break;
    case 4: preagg_kernel<6><<<tiles, PA_THREADS, 0, s>>>(args); break;
    case 5: preagg_kernel<7><<<tiles, PA_THREADS, 0, s>>>(args); break;
    case 6: preagg_kernel<8><<<tiles, PA_THREADS, 0, s>>>(args); break;
    case 7: preagg_kernel<9><<<tiles, PA_THREADS, 0, s>>>(args); break;
    case 8: preagg_kernel<10><<<tiles, PA_THREADS, 0, s>>>(args); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
