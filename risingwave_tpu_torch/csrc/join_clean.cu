// Kernel K15: watermark cleaning and pool compaction of a join side
// (sm_90a).
//
// Replaces risingwave_tpu/stream/hash_join.py `clean_below` (:1117, pool
// branch, with `TagTable.clear_where`) and `maybe_rehash`'s `compact_pool`
// (:1048).
//
//   rw_join_clean    one elementwise pass over the tag table: an occupied
//                    entry (tag not 0 or 1) whose window key
//                    slot_clean < threshold becomes a tombstone and its
//                    degree 0.  The same pass counts the tombstones and the
//                    live entries left, which the barrier reads (with the
//                    pool cursor) to decide `maybe_rehash`'s rebuild and
//                    compaction, so the table is read once.
//   rw_join_compact  live entries' pool rows move to a dense prefix in slot
//                    order: per 1024-slot tile the live count, one block
//                    scanning the tile counts (which also writes pool_len),
//                    then per tile a block scan giving each live slot its
//                    new position, written to moved[old pool_pos] and to
//                    pool_pos.  The rows themselves then move through K4
//                    (permute.cu).
//
// Bound: bytes.  The clean reads the 8 B tag and 8 B window key of every
// slot and writes the changed ones (2^22 slots: ~67 MB, ~20 us at HBM
// rate); the compaction reads tags and pool_pos and writes moved and
// pool_pos (~84 MB at 2^22).
#include "rw_common.cuh"
#include "rw_join.cuh"

constexpr int CLEAN_THREADS = 256;
constexpr int CP_TILE = 1024;

__global__ void __launch_bounds__(CLEAN_THREADS)
    join_clean_kernel(long long* tags, int* count,
                      const long long* slot_clean, const long long* threshold,
                      int* stats, int size) {
  const long long thr = threshold[0];
  int tombs = 0, live = 0;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < size; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long t = tags[i];
    const bool occ = t != 0 && t != 1;
    if (occ && slot_clean[i] < thr) {
      tags[i] = 1;
      count[i] = 0;
      ++tombs;
    } else {
      tombs += t == 1;
      live += occ;
    }
  }
  int total;
  rw_block_exclusive_scan<RwSum>(tombs, &total);
  if (threadIdx.x == 0 && total) atomicAdd(&stats[0], total);
  rw_block_exclusive_scan<RwSum>(live, &total);
  if (threadIdx.x == 0 && total) atomicAdd(&stats[1], total);
}

extern "C" int rw_join_clean(long long* tags, int* count,
                             const long long* slot_clean,
                             const long long* threshold, int* stats, int size,
                             void* stream) {
  if (size > 0) {
    int blocks = (size + CLEAN_THREADS - 1) / CLEAN_THREADS;
    if (blocks > 132 * 16) blocks = 132 * 16;
    join_clean_kernel<<<blocks, CLEAN_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        tags, count, slot_clean, threshold, stats, size);
  }
  return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(CP_TILE)
    compact_count_kernel(const long long* tags, int* tiles, int* moved,
                         int size, int pool) {
  const long long i = static_cast<long long>(blockIdx.x) * CP_TILE +
                      threadIdx.x;
  int occ = 0;
  if (i < size) {
    const long long t = tags[i];
    occ = t != 0 && t != 1;
  }
  int total;
  rw_block_exclusive_scan<RwSum>(occ, &total);
  if (threadIdx.x == 0) tiles[blockIdx.x] = total;
  for (long long j = i; j < pool;
       j += static_cast<long long>(gridDim.x) * CP_TILE) {
    moved[j] = pool;  // dead rows keep the drop sentinel
  }
}

__global__ void __launch_bounds__(1024)
    compact_tiles_kernel(int* tiles, int n_tiles, int* pool_len) {
  const int per = (n_tiles + blockDim.x - 1) / blockDim.x;
  const int lo = threadIdx.x * per < n_tiles ? threadIdx.x * per : n_tiles;
  const int hi = lo + per < n_tiles ? lo + per : n_tiles;
  int mine = 0;
  for (int b = lo; b < hi; ++b) mine += tiles[b];
  int total;
  int run = rw_block_exclusive_scan<RwSum>(mine, &total);
  for (int b = lo; b < hi; ++b) {
    const int c = tiles[b];
    tiles[b] = run;  // exclusive prefix of the live counts
    run += c;
  }
  if (threadIdx.x == 0) pool_len[0] = total;
}

__global__ void __launch_bounds__(CP_TILE)
    compact_write_kernel(const long long* tags, int* pool_pos,
                         const int* tiles, int* moved, int size, int pool) {
  const long long i = static_cast<long long>(blockIdx.x) * CP_TILE +
                      threadIdx.x;
  int occ = 0;
  if (i < size) {
    const long long t = tags[i];
    occ = t != 0 && t != 1;
  }
  int total;
  const int excl = rw_block_exclusive_scan<RwSum>(occ, &total);
  if (!occ) return;
  const int new_pos = tiles[blockIdx.x] + excl;
  const int old = pool_pos[i];
  if (old >= 0 && old < pool) moved[old] = new_pos;
  pool_pos[i] = new_pos;
}

extern "C" int rw_join_compact(const long long* tags, int* pool_pos,
                               int* moved, int* pool_len, int* tiles,
                               int size, int pool, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (size + CP_TILE - 1) / CP_TILE;
  if (n_tiles > 0) {
    compact_count_kernel<<<n_tiles, CP_TILE, 0, s>>>(tags, tiles, moved, size,
                                                     pool);
    compact_tiles_kernel<<<1, 1024, 0, s>>>(tiles, n_tiles, pool_len);
    compact_write_kernel<<<n_tiles, CP_TILE, 0, s>>>(tags, pool_pos, tiles,
                                                     moved, size, pool);
  }
  return static_cast<int>(cudaGetLastError());
}
