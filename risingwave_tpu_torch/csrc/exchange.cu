// Kernel K24: the hash exchange of a lane mesh (sm_90a).
//
// Replaces risingwave_tpu/parallel/exchange.py `shuffle_chunk` (:124) with
// `shard_of_vnode` (:92) and `_bucketize` (:104), and the `lax.all_to_all`
// that follows them inside the reference's shard_map.  Every lane of the
// mesh lives on this one card, so the all_to_all is a scatter: row i of
// source lane s goes to dest lane d = min(vnode / (vnode_count / n), n - 1)
// at position s * cap + rank, where rank is the row's STABLE rank among
// lane s's rows bound for d; an invalid row goes nowhere.  The receive
// buffers are [n, n * cap] per leaf (dest-major), so lane d's chunk is the
// contiguous view recv[d]: byte for byte what `_bucketize` and
// all_to_all(split_axis=0, concat_axis=0) give.  Every slot that no row
// fills is written with its leaf's fill byte (0, or 1 for an NCol's null
// plane: zero payload, NULL, op 0, not valid), as the reference's buffers
// are initialised.
//
// A leaf is one plane of the chunk: a column's payload, a string's [cap, W]
// bytes and its int32 lengths, a null plane, the ops, the valid plane.
// Three launches, each over (row block, source lane):
//   1. x_count_kernel    each block counts its rows per destination
//                        (shared-memory atomics);
//   2. x_scan_kernel     per source lane and destination, an exclusive scan
//                        of those counts over the blocks, and the total;
//   3. x_scatter_kernel  each row's rank: its block's offset, the counts of
//                        the earlier warps of the block, and its rank in its
//                        warp among the lanes with its destination
//                        (__match_any_sync and a popcount), so rows keep
//                        their order; then its planes are copied, and every
//                        thread fills, for each destination, its slot of the
//                        source's segment when no row reached it.
//
// Bound: bytes.  Every valid row's planes are read once and written once,
// and every slot no row fills is written once (n * n * cap slots in all);
// the vnodes and valid planes are read twice.  With all rows of a chunk
// bound for one lane (q7's single window) the writes of one destination
// are still spread over all blocks.
#include <cstdint>
#include <cuda_runtime.h>

#define X_MAX_LANES 8
#define X_MAX_LEAVES 24
#define X_THREADS 256
#define X_WARPS (X_THREADS / 32)

struct RwExchange {
  int n_lanes;
  int n_leaves;
  int per;  // vnodes per lane: vnode_count / n_lanes
  long long cap;
  const int32_t* vnode[X_MAX_LANES];
  const uint8_t* valid[X_MAX_LANES];
  int width[X_MAX_LEAVES];  // bytes a row holds in the leaf
  int fill[X_MAX_LEAVES];   // byte an unfilled slot holds
  const void* src[X_MAX_LANES][X_MAX_LEAVES];
  void* dst[X_MAX_LEAVES];  // [n_lanes, n_lanes * cap] rows
};

__device__ __forceinline__ int x_dest(const RwExchange& x, int s, long long i) {
  if (i >= x.cap || x.valid[s][i] == 0) return x.n_lanes;
  const int d = x.vnode[s][i] / x.per;
  return d < x.n_lanes - 1 ? d : x.n_lanes - 1;
}

__device__ __forceinline__ void x_copy(uint8_t* pd, const uint8_t* ps, int w) {
  if ((w & 7) == 0) {
    for (int j = 0; j < w; j += 8) {
      *reinterpret_cast<uint64_t*>(pd + j) =
          *reinterpret_cast<const uint64_t*>(ps + j);
    }
  } else if ((w & 3) == 0) {
    for (int j = 0; j < w; j += 4) {
      *reinterpret_cast<uint32_t*>(pd + j) =
          *reinterpret_cast<const uint32_t*>(ps + j);
    }
  } else if ((w & 1) == 0) {
    for (int j = 0; j < w; j += 2) {
      *reinterpret_cast<uint16_t*>(pd + j) =
          *reinterpret_cast<const uint16_t*>(ps + j);
    }
  } else {
    for (int j = 0; j < w; ++j) pd[j] = ps[j];
  }
}

__device__ __forceinline__ void x_fill(uint8_t* pd, int w, int fill) {
  for (int j = 0; j < w; ++j) pd[j] = static_cast<uint8_t>(fill);
}

// counts[(s * nblk + b) * n + d]
__global__ void __launch_bounds__(X_THREADS)
x_count_kernel(RwExchange x, int* __restrict__ counts) {
  __shared__ int c[X_MAX_LANES + 1];
  const int s = blockIdx.y, b = blockIdx.x, n = x.n_lanes;
  if (threadIdx.x <= n) c[threadIdx.x] = 0;
  __syncthreads();
  const long long i = static_cast<long long>(b) * X_THREADS + threadIdx.x;
  const int d = x_dest(x, s, i);
  if (d < n) atomicAdd(&c[d], 1);
  __syncthreads();
  if (threadIdx.x < n) {
    counts[(static_cast<long long>(s) * gridDim.x + b) * n + threadIdx.x] =
        c[threadIdx.x];
  }
}

// offsets[(s * nblk + b) * n + d] (exclusive), totals[s * n + d]
__global__ void x_scan_kernel(int n, int nblk, const int* __restrict__ counts,
                              int* __restrict__ offsets,
                              int* __restrict__ totals) {
  const int s = blockIdx.x, d = threadIdx.x;
  if (d >= n) return;
  int run = 0;
  for (int b = 0; b < nblk; ++b) {
    const long long k = (static_cast<long long>(s) * nblk + b) * n + d;
    offsets[k] = run;
    run += counts[k];
  }
  totals[s * n + d] = run;
}

__global__ void __launch_bounds__(X_THREADS)
x_scatter_kernel(RwExchange x, const int* __restrict__ offsets,
                 const int* __restrict__ totals) {
  __shared__ int wc[X_WARPS][X_MAX_LANES + 1];
  const int s = blockIdx.y, b = blockIdx.x, n = x.n_lanes;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = threadIdx.x; k < X_WARPS * (X_MAX_LANES + 1); k += X_THREADS) {
    wc[k / (X_MAX_LANES + 1)][k % (X_MAX_LANES + 1)] = 0;
  }
  __syncthreads();
  const long long i = static_cast<long long>(b) * X_THREADS + threadIdx.x;
  const int d = x_dest(x, s, i);
  const unsigned same = __match_any_sync(0xFFFFFFFFu, d);
  const int in_warp = __popc(same & ((1u << lane) - 1u));
  if (in_warp == 0) wc[warp][d] = __popc(same);
  __syncthreads();
  const long long seg = static_cast<long long>(n) * x.cap;  // a dest's rows
  if (d < n) {
    int rank = offsets[(static_cast<long long>(s) * gridDim.x + b) * n + d] +
               in_warp;
    for (int w = 0; w < warp; ++w) rank += wc[w][d];
    const long long slot = d * seg + s * x.cap + rank;
    for (int k = 0; k < x.n_leaves; ++k) {
      const int w = x.width[k];
      x_copy(static_cast<uint8_t*>(x.dst[k]) + slot * w,
             static_cast<const uint8_t*>(x.src[s][k]) + i * w, w);
    }
  }
  if (i < x.cap) {
    for (int e = 0; e < n; ++e) {
      if (i < totals[s * n + e]) continue;
      const long long slot = e * seg + s * x.cap + i;
      for (int k = 0; k < x.n_leaves; ++k) {
        const int w = x.width[k];
        x_fill(static_cast<uint8_t*>(x.dst[k]) + slot * w, w, x.fill[k]);
      }
    }
  }
}

// scratch: 2 * n * nblk + n ints (counts, offsets, totals)
extern "C" int rw_exchange(RwExchange x, void* scratch, void* stream) {
  if (x.cap <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = static_cast<int>((x.cap + X_THREADS - 1) / X_THREADS);
  const long long per_arr = static_cast<long long>(x.n_lanes) * nblk * x.n_lanes;
  int* counts = static_cast<int*>(scratch);
  int* offsets = counts + per_arr;
  int* totals = offsets + per_arr;
  const dim3 grid(nblk, x.n_lanes);
  x_count_kernel<<<grid, X_THREADS, 0, st>>>(x, counts);
  x_scan_kernel<<<x.n_lanes, 32, 0, st>>>(x.n_lanes, nblk, counts, offsets,
                                          totals);
  x_scatter_kernel<<<grid, X_THREADS, 0, st>>>(x, offsets, totals);
  return static_cast<int>(cudaGetLastError());
}
