// Kernel D: primary-key upsert of a changelog chunk into an MV (sm_90a).
//
// Replaces risingwave_tpu/stream/materialize.py `MaterializeExecutor.apply`
// (materialize.py:108) after its probe: the last op in ROW ORDER wins per
// slot, so a [+pk, -pk] chunk ends absent and a [-pk, +pk] chunk present.
//   1. mark_kernel: atomicMax of the row index into last_del / last_ins
//      (int32 [size], -1 when untouched) for delete-side and insert-side
//      rows;
//   2. apply_kernel: a delete row whose index beats the slot's last insert
//      clears the slot (occupied = 0, tombstone = 1); the unique insert row
//      that is the slot's last insert and beats its last delete sets
//      occupied, clears the tombstone and writes every value column;
//   3. reset_kernel: the rows reset the scratch entries they touched (the
//      [size] scratch stays -1 between chunks and is never swept whole).
// No value store sees two writers: the winner of a slot is unique, which is
// what `index_put_` with duplicate indices would not guarantee on CUDA.
//
// Bound: bytes.  Per row: slot 4 B, op 1 B, valid 1 B, the value row read
// once; per winning slot the value row written once.  At the q7 shapes (a
// few thousand flushed rows) that is well under launch latency; three
// launches of one thread per row keep each phase's reads after the previous
// phase's writes.
#include "rw_common.cuh"

struct MvArgs {
  RwCols values;          // in = chunk columns, st = MV value stores
  const int32_t* slots;   // [cap] from the probe (size = sentinel)
  const uint8_t* valid;   // [cap]
  const int8_t* ops;      // [cap]
  int32_t* last_del;      // [size] scratch, -1 outside a launch
  int32_t* last_ins;      // [size] scratch, -1 outside a launch
  uint8_t* occupied;      // [size]
  uint8_t* tombstone;     // [size]
  int cap;
  int size;
};

__device__ __forceinline__ bool rw_is_del(int8_t op) { return op == 1 || op == 2; }
__device__ __forceinline__ bool rw_is_ins(int8_t op) { return op == 0 || op == 3; }

__global__ void mark_kernel(MvArgs a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.cap || !a.valid[r]) return;
  const int s = a.slots[r];
  if (s >= a.size) return;
  const int8_t op = a.ops[r];
  if (rw_is_del(op)) atomicMax(&a.last_del[s], r);
  if (rw_is_ins(op)) atomicMax(&a.last_ins[s], r);
}

__global__ void apply_kernel(MvArgs a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.cap || !a.valid[r]) return;
  const int s = a.slots[r];
  if (s >= a.size) return;
  const int8_t op = a.ops[r];
  const int ld = a.last_del[s];
  const int li = a.last_ins[s];
  if (rw_is_del(op) && ld > li) {
    a.occupied[s] = 0;
    a.tombstone[s] = 1;
  }
  if (rw_is_ins(op) && li == r && li > ld) {
    a.occupied[s] = 1;
    a.tombstone[s] = 0;
    rw_store_row(a.values, s, r);
  }
}

__global__ void reset_kernel(MvArgs a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.cap || !a.valid[r]) return;
  const int s = a.slots[r];
  if (s >= a.size) return;
  a.last_del[s] = -1;
  a.last_ins[s] = -1;
}

extern "C" int rw_mv_upsert(MvArgs args, void* stream) {
  if (args.cap > 0) {
    const int threads = 256;
    const int blocks = (args.cap + threads - 1) / threads;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    mark_kernel<<<blocks, threads, 0, st>>>(args);
    apply_kernel<<<blocks, threads, 0, st>>>(args);
    reset_kernel<<<blocks, threads, 0, st>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}
