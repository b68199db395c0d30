// Kernel K23c: (regexp_match(s, '(&|^)literal([^X]*)'))[2] (sm_90a).
//
// Replaces risingwave_tpu/expr/scalar.py:1057 `RegexpGroup.eval`, the
// capture of the pattern family `_RX_FAMILY` (:1017) compiled at bind time
// into a literal, an optional guard byte and a stop byte.
//
// One thread per row finds the first offset where the literal occurs whole
// inside the string and, with a guard, sits at offset 0 or right after the
// guard byte (`(&|^)`).  Without a guard the match is not anchored, as in
// the reference.  The capture starts after the literal and runs to the
// first stop byte or the end of the string.  The kernel writes the capture
// from offset 0 with zeros to the end of the row, its length, and `found`;
// an unmatched row is the empty string with found = 0 (the wrapper makes
// it NULL, as it does a NULL input row).
//
// Bound: bytes.  Each row's bytes are read up to the capture's end and
// width + 5 bytes written; the literal (in global memory, the same bytes
// for every row) stays in L1.  The literal compare at each offset is the
// work; it ends at the first mismatching byte.
#include "rw_str.cuh"

__global__ void regexp_group_kernel(RwStr s, const uint8_t* __restrict__ lit,
                                    int lit_len, int guard, int stop,
                                    long long n, uint8_t* __restrict__ out,
                                    int32_t* __restrict__ out_len,
                                    uint8_t* __restrict__ found) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  const uint8_t* p = rw_str_row(s, i);
  const int ls = rw_str_len(s, i);
  int first = -1;
  for (int off = 0; off + lit_len <= ls; ++off) {
    if (guard >= 0 && off > 0 && p[off - 1] != guard) continue;
    if (rw_bytes_eq(p + off, lit, lit_len)) {
      first = off;
      break;
    }
  }
  int start = 0, len = 0;
  if (first >= 0) {
    start = first + lit_len;
    int e = start;
    while (e < ls && p[e] != stop) ++e;
    len = e - start;
  }
  uint8_t* o = out + i * s.width;
  for (int j = 0; j < s.width; ++j) o[j] = j < len ? p[start + j] : 0;
  out_len[i] = len;
  found[i] = first >= 0 ? 1 : 0;
}

extern "C" int rw_regexp_group(RwStr s, const void* lit, int lit_len,
                               int guard, int stop, long long n, void* out,
                               void* out_len, void* found, void* stream) {
  if (n > 0) {
    regexp_group_kernel<<<rw_blocks(n, 128), 128, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        s, static_cast<const uint8_t*>(lit), lit_len, guard, stop, n,
        static_cast<uint8_t*>(out), static_cast<int32_t*>(out_len),
        static_cast<uint8_t*>(found));
  }
  return static_cast<int>(cudaGetLastError());
}
