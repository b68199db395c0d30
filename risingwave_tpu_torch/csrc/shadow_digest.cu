// Kernel K11: the shadow snapshot's fused block digest, diff and dirty
// copy, and the checkpoint delta's dirty-block gather (sm_90a).
//
// Replaces risingwave_tpu/stream/shadow.py `_build_programs` (`init` :198,
// `update` :214-247, with `_copy_leaf` :67) over
// risingwave_tpu/storage/digest.py `leaf_digest` (:96), `_pack_words` (:68)
// and `normalize_u64` (:36); and the delta branch of
// risingwave_tpu/storage/checkpoint_store.py `prepare` (:249-280).
//
// K11 lanes (`rw_shadow_digest_lanes`, `rw_dirty_gather_lanes`): the same
// kernels over a lane grid, replacing shadow.py `_copy_leaf_rows` (:122)
// over digest.py `leaf_digest_lanes` (:130) and the lane walk of
// checkpoint_store.py `prepare` (:246-270).  A leaf of `rows` lanes (a
// lane-stacked state [rows, ...], m = n / rows elements a row) has
// nb / rows blocks a row: block b is (r = b / nb_row, c = b % nb_row) and
// covers elements [r*m + c*block, min(r*m + (c+1)*block, (r+1)*m)).  Its
// words pack per row, are zero past the ROW's end and mix with the
// row-local word index; each row's ragged tail copies always, and the
// whole-leaf rule reads rows * nb_row <= 8 or rows * (m / block) < 2.  A
// flat leaf is one row.
//
//   rw_shadow_digest  ONE launch for a whole state tree (up to
//                     SD_MAX_LEAVES leaves, described by value in the
//                     kernel's parameters).  Each digest block (`block`
//                     elements of one leaf) is a unit of work for one warp:
//                     1. its 64-bit words: an 8-byte element is one word
//                        (float64 through the reference's frexp, nan/±inf
//                        pinned to sentinels, -0.0 as +0.0, subnormals as
//                        the reference computes them: mantissa ±0.5,
//                        exponent -1074); narrower elements pack 64/bits to
//                        a word, element j at bit j*bits (a little-endian
//                        8-byte load when the word is whole), zero past the
//                        end of the leaf;
//                     2. the wrapping sum of rw_mix64(word ^ idx*GOLD ^ GOLD)
//                        over the block, idx the word's index in the leaf's
//                        zero-padded word stream (a warp shuffle reduction:
//                        the sum is associative, so it is exact);
//                     3. compare with the old digest (update mode);
//                     4. if the block is dirty, copy its elements live ->
//                        shadow and store the new digest; a leaf of at most
//                        8 blocks or fewer than 2 full blocks copies whole,
//                        and a ladder leaf's ragged tail block always copies
//                        (as `_copy_leaf`);
//                     5. count the dirty blocks of ladder leaves (one atomic
//                        per thread block) into `dirty_count`.
//                     Init mode digests and copies every block (a null
//                     shadow pointer digests only: the store's own pass).
//   rw_dirty_gather   packs a list of (leaf, block) pairs of the shadow into
//                     a staging buffer, in list order, at the byte offsets the
//                     host computed; one async copy then brings it to pinned
//                     host memory and the host cuts the `r_{i}_{start}` runs.
//
// The reference's budget ladder (copy 1/64, then 1/8 of a leaf's blocks,
// else the whole leaf, chosen with lax.switch) exists because XLA needs
// static gather sizes.  Copying exactly the dirty blocks leaves the same
// shadow contents: a rung copies the dirty blocks plus clean blocks whose
// contents already equal the shadow's.  The one exception is a 64-bit digest
// collision (a changed block with an unchanged digest), which both skip and
// whose odds the reference accepts (shadow.py:42-44).
//
// Bound: bytes.  The update reads every live byte once and writes the dirty
// blocks (their re-read hits L2); at q8's 1008 MB state that is ~0.3 ms at
// 3.35 TB/s.  The integer work is ~3 64-bit multiplies (several 32-bit IMADs
// each) and ~9 other ops per 8-byte word, ~1.6e9 ops at 1008 MB: close to the
// byte bound, so the loads are 8 bytes wide and each warp keeps several in
// flight.
#include <cstdint>
#include <cuda_runtime.h>

#include "rw_common.cuh"

#define SD_MAX_LEAVES 64

constexpr int SD_THREADS = 256;
constexpr int SD_WARPS = SD_THREADS / 32;

// flags
constexpr int SD_LADDER = 1;  // counts its dirty blocks
constexpr int SD_WHOLE = 2;   // small leaf: copy every block
constexpr int SD_F64 = 4;     // float64 normalisation

struct SdLeaf {
  const uint8_t* live;  // digest source (update/init), gather source
  uint8_t* shadow;      // copy target (null: digest only)
  long long n;          // elements
  long long blk0;       // first block in the digest vector
  int nb;               // blocks (of every row)
  int esize;            // element bytes: 1, 2, 4 or 8
  int flags;
  int rows;             // lanes (1: a flat leaf)
};

struct SdDesc {
  int n_leaves;
  int block;  // elements per block (a power of two >= 8)
  long long total;  // blocks of all leaves
  SdLeaf leaf[SD_MAX_LEAVES];
};

__device__ __forceinline__ int sd_find_leaf(const SdLeaf* leaves, int n,
                                            long long g) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (leaves[mid].blk0 <= g) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ uint64_t sd_f64_word(uint64_t bits) {
  const double x = __longlong_as_double(static_cast<long long>(bits));
  const uint64_t expf = (bits >> 52) & 0x7FF;
  const uint64_t frac = bits & ((1ull << 52) - 1);
  if (expf == 0x7FF) {
    if (frac != 0) return static_cast<uint64_t>(-(1ll << 62));  // nan
    return (bits >> 63) ? static_cast<uint64_t>(-(1ll << 62) + 1)
                        : static_cast<uint64_t>(1ll << 62);
  }
  if (expf == 0 && frac == 0) return 0;  // ±0
  long long m2;
  long long e;
  if (expf == 0) {  // subnormal, as the reference's frexp gives it
    m2 = (bits >> 63) ? -(1ll << 52) : (1ll << 52);
    e = -1074;
  } else {
    int ei;
    const double m = frexp(x, &ei);
    m2 = static_cast<long long>(m * 9007199254740992.0);  // 2^53, exact
    e = ei;
  }
  return static_cast<uint64_t>(m2) ^ (static_cast<uint64_t>(e) << 53);
}

// Word `w` of block `c` of a row of `m` elements at `row` (zero past the
// row's end).
__device__ __forceinline__ uint64_t sd_word(const SdLeaf& L, const uint8_t* row,
                                            long long m, int block,
                                            long long c, long long w) {
  if (L.esize == 8) {
    const long long e = c * block + w;
    if (e >= m) return 0;
    const uint64_t v = reinterpret_cast<const uint64_t*>(row)[e];
    return (L.flags & SD_F64) ? sd_f64_word(v) : v;
  }
  const int k = 8 / L.esize;
  const long long e0 = c * block + w * k;
  const uint8_t* p = row + e0 * L.esize;
  if (e0 + k <= m && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    // element j of the word at bit j*bits: a little-endian 8-byte load
    return *reinterpret_cast<const uint64_t*>(p);
  }
  uint64_t v = 0;
  for (int j = 0; j < k && e0 + j < m; ++j) {
    v |= rw_load_word(row, L.esize, e0 + j) << (j * 8 * L.esize);
  }
  return v;
}

// Block `b` of a leaf as (first element of its row, its block in the row,
// the row's elements).
template <bool LANES>
__device__ __forceinline__ void sd_locate(const SdLeaf& L, long long b,
                                          long long* row0, long long* c,
                                          long long* m) {
  if (!LANES) {
    *row0 = 0;
    *c = b;
    *m = L.n;
    return;
  }
  const long long nb_row = L.nb / L.rows;
  const long long r = b / nb_row;
  *m = L.n / L.rows;
  *c = b - r * nb_row;
  *row0 = r * *m;
}

// Copy `bytes` bytes src -> dst across the warp (16-byte units where both
// are 16-byte aligned).
__device__ __forceinline__ void sd_warp_copy(uint8_t* dst, const uint8_t* src,
                                             long long bytes, int lane) {
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) |
        reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const long long n16 = bytes >> 4;
    for (long long i = lane; i < n16; i += 32) {
      reinterpret_cast<uint4*>(dst)[i] =
          reinterpret_cast<const uint4*>(src)[i];
    }
    done = n16 << 4;
  }
  for (long long i = done + lane; i < bytes; i += 32) dst[i] = src[i];
}

template <bool LANES>
__global__ void __launch_bounds__(SD_THREADS)
    shadow_digest_kernel(const __grid_constant__ SdDesc d,
                         unsigned long long* digests,
                         unsigned long long* dirty_count, int update) {
  __shared__ SdLeaf leaves[SD_MAX_LEAVES];
  __shared__ unsigned long long block_dirty;
  for (int i = threadIdx.x; i < d.n_leaves; i += blockDim.x) {
    leaves[i] = d.leaf[i];
  }
  if (threadIdx.x == 0) block_dirty = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warp0 =
      static_cast<long long>(blockIdx.x) * SD_WARPS + (threadIdx.x >> 5);
  const long long n_warps = static_cast<long long>(gridDim.x) * SD_WARPS;
  unsigned long long my_dirty = 0;
  const uint64_t gold = RW_K1;
  for (long long g = warp0; g < d.total; g += n_warps) {
    const SdLeaf& L = leaves[sd_find_leaf(leaves, d.n_leaves, g)];
    long long row0, c, m;
    sd_locate<LANES>(L, g - L.blk0, &row0, &c, &m);
    const uint8_t* row = L.live + row0 * L.esize;
    const long long wpb = static_cast<long long>(d.block) * L.esize / 8;
    uint64_t acc = 0;
    for (long long w = lane; w < wpb; w += 32) {
      const uint64_t idx = static_cast<uint64_t>(c * wpb + w);
      acc += rw_mix64(sd_word(L, row, m, d.block, c, w) ^ (idx * gold) ^
                      gold);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    // lane 0 reads the old digest before any lane can store the new one
    unsigned long long old = 0;
    if (update && lane == 0) old = digests[g];
    old = __shfl_sync(0xffffffffu, old, 0);
    const bool dirty = !update || acc != old;
    const long long e0 = row0 + c * d.block;
    const long long e1 = row0 + min((c + 1) * d.block, m);
    const bool tail = e1 - e0 < d.block;
    if (dirty && lane == 0) {
      digests[g] = acc;
      if (update && (L.flags & SD_LADDER)) ++my_dirty;
    }
    if (L.shadow != nullptr && e1 > e0 &&
        (dirty || (L.flags & SD_WHOLE) || tail)) {
      sd_warp_copy(L.shadow + e0 * L.esize, L.live + e0 * L.esize,
                   (e1 - e0) * L.esize, lane);
    }
  }
  if (update) {
    if (lane == 0 && my_dirty) atomicAdd(&block_dirty, my_dirty);
    __syncthreads();
    if (threadIdx.x == 0 && block_dirty) atomicAdd(dirty_count, block_dirty);
  }
}

static int sd_grid(long long units) {
  long long blocks = (units + SD_WARPS - 1) / SD_WARPS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return blocks < 1 ? 1 : static_cast<int>(blocks);
}

template <bool LANES>
static int sd_launch(const SdDesc* desc, unsigned long long* digests,
                     unsigned long long* dirty_count, int update,
                     void* stream) {
  if (desc->n_leaves < 1 || desc->n_leaves > SD_MAX_LEAVES) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (desc->total > 0) {
    shadow_digest_kernel<LANES><<<sd_grid(desc->total), SD_THREADS, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        *desc, digests, dirty_count, update);
  }
  return static_cast<int>(cudaGetLastError());
}

// update = 0: init (digest + copy everything; shadow null = digest only);
// update = 1: diff against `digests`, copy the dirty blocks, count them.
extern "C" int rw_shadow_digest(const SdDesc* desc, unsigned long long* digests,
                                unsigned long long* dirty_count, int update,
                                void* stream) {
  return sd_launch<false>(desc, digests, dirty_count, update, stream);
}

// The same over the lane grid (`SdLeaf.rows` lanes a leaf).
extern "C" int rw_shadow_digest_lanes(const SdDesc* desc,
                                      unsigned long long* digests,
                                      unsigned long long* dirty_count,
                                      int update, void* stream) {
  return sd_launch<true>(desc, digests, dirty_count, update, stream);
}

// entries[2*i] = leaf << 32 | block, entries[2*i + 1] = byte offset of the
// block in `staging`.
template <bool LANES>
__global__ void __launch_bounds__(SD_THREADS)
    dirty_gather_kernel(const __grid_constant__ SdDesc d,
                        const long long* entries, long long m,
                        uint8_t* staging) {
  __shared__ SdLeaf leaves[SD_MAX_LEAVES];
  for (int i = threadIdx.x; i < d.n_leaves; i += blockDim.x) {
    leaves[i] = d.leaf[i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warp0 =
      static_cast<long long>(blockIdx.x) * SD_WARPS + (threadIdx.x >> 5);
  const long long n_warps = static_cast<long long>(gridDim.x) * SD_WARPS;
  for (long long i = warp0; i < m; i += n_warps) {
    const long long key = entries[2 * i];
    const SdLeaf& L = leaves[static_cast<int>(key >> 32)];
    long long row0, c, m;
    sd_locate<LANES>(L, key & 0xFFFFFFFFll, &row0, &c, &m);
    const long long e0 = row0 + c * d.block;
    const long long e1 = row0 + min((c + 1) * d.block, m);
    if (e1 > e0) {
      sd_warp_copy(staging + entries[2 * i + 1], L.live + e0 * L.esize,
                   (e1 - e0) * L.esize, lane);
    }
  }
}

template <bool LANES>
static int dg_launch(const SdDesc* desc, const long long* entries,
                     long long m, uint8_t* staging, void* stream) {
  if (desc->n_leaves < 1 || desc->n_leaves > SD_MAX_LEAVES) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m > 0) {
    dirty_gather_kernel<LANES><<<sd_grid(m), SD_THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        *desc, entries, m, staging);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rw_dirty_gather(const SdDesc* desc, const long long* entries,
                               long long m, uint8_t* staging, void* stream) {
  return dg_launch<false>(desc, entries, m, staging, stream);
}

extern "C" int rw_dirty_gather_lanes(const SdDesc* desc,
                                     const long long* entries, long long m,
                                     uint8_t* staging, void* stream) {
  return dg_launch<true>(desc, entries, m, staging, stream);
}
