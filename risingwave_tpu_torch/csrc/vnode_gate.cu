// K25: the vnode gate of a partition (sm_90a).
//
// Replaces risingwave_tpu/cluster/scale/vnode.py `vnodes_of_ints` (:29) and
// `vnode_member_mask` (:47) as the gate reads it, and
// risingwave_tpu/cluster/scale/gate.py `VnodeGateExecutor.apply` (:81).
//
// One thread per row of the chunk:
//   vnode = rw_common.cuh's rw_vnode_of_int: hash64([key as int64]) (K1's
//           hash helpers, ~0 remapped to ~1) mod n_vnodes, unsigned;
//   keep  = member[vnode] & valid;
//   ops   = a U- whose partner row (i + 1) mod cap is not kept becomes a
//           Delete, a U+ whose partner (i - 1) mod cap is not kept an
//           Insert: the reference's jnp.roll wraps around the capacity, not
//           the valid rows, and so does this (a thread rehashes the one
//           neighbour it needs);
//   dropped += count(valid & !keep): rw_block_sum_add.
// The vnode-only form (member == nullptr) writes `vnode` and nothing else.
//
// Bound: bytes.  Per row it reads the key (8 B), valid and op (2 B), and
// writes keep and op (2 B); the member mask (n_vnodes bytes) is read once
// and stays in cache.  The hash is ~20 integer operations a row, far under
// the card's integer rate.
#include "rw_common.cuh"

struct VnodeGateArgs {
  const void* key;         // [cap] integer key, `key_width` bytes a row
  int key_width;           // 1, 2, 4 or 8 (sign-extended to int64)
  int cap;
  int n_vnodes;
  int* vnode;              // [cap] out, or null
  const uint8_t* member;   // [n_vnodes], or null (vnode-only form)
  const uint8_t* valid;    // [cap]
  const int8_t* ops;       // [cap]
  int8_t* ops_out;         // [cap]
  uint8_t* keep_out;       // [cap]
  unsigned long long* dropped;  // int64 scalar, added to in place
};

static constexpr int8_t GATE_OP_INSERT = 0;
static constexpr int8_t GATE_OP_DELETE = 1;
static constexpr int8_t GATE_OP_UPDATE_DELETE = 2;
static constexpr int8_t GATE_OP_UPDATE_INSERT = 3;

__device__ __forceinline__ int gate_vnode(const VnodeGateArgs& a, int64_t i) {
  return rw_vnode_of_int(rw_load_int(a.key, a.key_width, i), a.n_vnodes);
}

__device__ __forceinline__ bool gate_keep(const VnodeGateArgs& a, int64_t i) {
  return a.valid[i] != 0 && a.member[gate_vnode(a, i)] != 0;
}

__global__ void vnode_gate_kernel(VnodeGateArgs a) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  int drop = 0;
  if (i < a.cap) {
    if (a.member == nullptr) {
      a.vnode[i] = gate_vnode(a, i);
    } else {
      const int vn = gate_vnode(a, i);
      if (a.vnode != nullptr) a.vnode[i] = vn;
      const bool valid = a.valid[i] != 0;
      const bool keep = valid && a.member[vn] != 0;
      int8_t op = a.ops[i];
      if (keep && op == GATE_OP_UPDATE_DELETE) {
        if (!gate_keep(a, (i + 1) % a.cap)) op = GATE_OP_DELETE;
      } else if (keep && op == GATE_OP_UPDATE_INSERT) {
        if (!gate_keep(a, (i + a.cap - 1) % a.cap)) op = GATE_OP_INSERT;
      }
      a.keep_out[i] = keep ? 1 : 0;
      a.ops_out[i] = op;
      drop = (valid && !keep) ? 1 : 0;
    }
  }
  if (a.member == nullptr) return;
  rw_block_sum_add(drop, a.dropped);
}

extern "C" int rw_vnode_gate(VnodeGateArgs args, void* stream) {
  if (args.cap > 0) {
    const int threads = 256;
    const int blocks = (args.cap + threads - 1) / threads;
    vnode_gate_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}
