// Shared walks of the bucket multi-maps: the dense join side's [size, B]
// row buckets (join_dense.cu, K13d) and the aggregation's [size, B] value
// buckets for retractable min/max (agg_minput.cu, K6m).  Both apply a
// retractable chunk in the reference's order (risingwave_tpu/stream/
// hash_join.py `_update_side`, risingwave_tpu/stream/hash_agg.py
// `_minput_update`): in-chunk +x/-x pairs cancel, each surviving delete
// clears the del_rank-th occupied entry equal to its value, then each
// surviving insert claims the ins_rank-th free entry of the post-delete
// bucket.
//
//   rw_bucket_cancel  the annihilation, one 1024-thread block (the device
//                     body `rw_bucket_cancel_block`): over the
//                     rows stably sorted by their pair hash (inserts and
//                     deletes; the rest last under the all-ones sentinel)
//                     it finds each segment's start (a running max), the
//                     exclusive counts of inserts and deletes before each
//                     position (block scans) and each segment's totals
//                     (written at its start); the k-th insert of a value
//                     cancels against the k-th delete of it, as the
//                     reference's `ins_rank < n_del` / `del_rank < n_ins`.
//                     A surviving delete's rank among the surviving
//                     deletes of its segment is its rank less the
//                     segment's insert total (the cancelled deletes are
//                     the segment's first), so the pass also writes that
//                     rank: K6m needs no second sort for it (K13d ranks
//                     its deletes among those K3 finds, after the pass).
//                     Each library that includes this header exports the
//                     pass as `rw_bucket_cancel`.
//   rw_bucket_pick    the rank-th entry of one bucket whose occupancy is
//                     `occupied` and that `pred` accepts, or -1; the
//                     callers split each phase into a read-only pick launch
//                     and a write launch, so every pick reads one snapshot.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "rw_join.cuh"

__device__ __forceinline__ void rw_bucket_cancel_block(
    const long long* sorted_key, const long long* order,
    const uint8_t* is_ins, const uint8_t* is_del, uint8_t* out_ins,
    uint8_t* out_del, int* out_del_rank, int* seg_start, int* pre_ins,
    int* pre_del, int* tot_ins, int* tot_del, int cap) {
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int per = (cap + T - 1) / T;
  const int lo = t * per < cap ? t * per : cap;
  const int hi = lo + per < cap ? lo + per : cap;
  // segment starts: a running max of the positions where the key changes
  int last = -1, n_ins = 0, n_del = 0;
  for (int i = lo; i < hi; ++i) {
    if (i == 0 || sorted_key[i] != sorted_key[i - 1]) last = i;
    n_ins += is_ins[order[i]];
    n_del += is_del[order[i]];
  }
  int total;
  int run = rw_block_exclusive_scan<RwMax>(last, &total);
  int ci = rw_block_exclusive_scan<RwSum>(n_ins, &total);
  int cd = rw_block_exclusive_scan<RwSum>(n_del, &total);
  for (int i = lo; i < hi; ++i) {
    if (i == 0 || sorted_key[i] != sorted_key[i - 1]) run = i;
    seg_start[i] = run;
    pre_ins[i] = ci;
    pre_del[i] = cd;
    ci += is_ins[order[i]];
    cd += is_del[order[i]];
  }
  __syncthreads();
  // each segment's last position writes the segment's totals at its start
  for (int i = lo; i < hi; ++i) {
    const int s = seg_start[i];
    const bool end = i + 1 >= cap || sorted_key[i + 1] != sorted_key[i];
    if (!end) continue;
    const long long row = order[i];
    tot_ins[s] = pre_ins[i] + is_ins[row] - pre_ins[s];
    tot_del[s] = pre_del[i] + is_del[row] - pre_del[s];
  }
  __syncthreads();
  for (int i = lo; i < hi; ++i) {
    const int s = seg_start[i];
    const long long row = order[i];
    const int ins_rank = pre_ins[i] - pre_ins[s];
    const int del_rank = pre_del[i] - pre_del[s];
    const bool del = is_del[row] && !(del_rank < tot_ins[s]);
    out_ins[row] = is_ins[row] && !(ins_rank < tot_del[s]);
    out_del[row] = del;
    out_del_rank[row] = del ? del_rank - tot_ins[s] : 0;
  }
}

__global__ void __launch_bounds__(1024)
    rw_bucket_cancel_kernel(const long long* sorted_key,
                            const long long* order, const uint8_t* is_ins,
                            const uint8_t* is_del, uint8_t* out_ins,
                            uint8_t* out_del, int* out_del_rank, int* scratch,
                            int cap) {
  rw_bucket_cancel_block(sorted_key, order, is_ins, is_del, out_ins,
                         out_del, out_del_rank, scratch, scratch + cap,
                         scratch + 2 * cap, scratch + 3 * cap,
                         scratch + 4 * cap, cap);
}

// scratch: 5 x cap ints
extern "C" int rw_bucket_cancel(const long long* sorted_key,
                                const long long* order,
                                const uint8_t* is_ins, const uint8_t* is_del,
                                uint8_t* out_ins, uint8_t* out_del,
                                int* out_del_rank, int* scratch, int cap,
                                void* stream) {
  if (cap > 0) {
    rw_bucket_cancel_kernel<<<1, 1024, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        sorted_key, order, is_ins, is_del, out_ins, out_del, out_del_rank,
        scratch, cap);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Pred>
__device__ __forceinline__ int rw_bucket_pick(const uint8_t* occupied,
                                              long long base, int B,
                                              bool want_occupied, int rank,
                                              Pred pred) {
  int seen = 0;
  for (int b = 0; b < B; ++b) {
    if ((occupied[base + b] != 0) != want_occupied) continue;
    if (!pred(base + b)) continue;
    if (seen == rank) return static_cast<int>(base + b);
    ++seen;
  }
  return -1;
}

struct RwAny {
  __device__ __forceinline__ bool operator()(long long) const { return true; }
};
