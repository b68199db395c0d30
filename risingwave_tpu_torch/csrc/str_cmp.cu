// Kernel K23d: string comparison and the byte case map (sm_90a).
//
// Replaces risingwave_tpu/expr/scalar.py:217 `_cmp_strs` with the string
// branch of `_make_cmp` (:241), and :438 `_lower` / :444 `_upper`.
//
// str_cmp: one thread per row walks both strings from byte 0.  Position j
// reads a's byte (0..255) while j < len(a) and -1 (end of string) past it,
// the same for b; the first position where the two differ decides every
// ordering, and rows equal up to max(len(a), len(b)) are equal.  Bytes
// compare unsigned.  The reference pads the narrower side with zeros to the
// wider width, so a length past a side's width reads 0 there.  `op` picks
// one of the six comparisons (0 eq, 1 ne, 2 lt, 3 le, 4 gt, 5 ge); either
// side may be a stride-0 literal.
//
// str_case_map: one thread per byte of the [n, width] output maps A-Z to
// a-z (lower) or a-z to A-Z (upper) and copies every other byte, the
// padding included, as the reference's whole-array `where` does; the
// lengths are the input's (the wrapper returns them as they are).
//
// Bound: bytes.  A comparison reads each row's bytes up to the first
// difference (a q21 channel against a literal: under 16 B of each) and its
// two lengths and writes 1 B; the case map reads and writes width bytes a
// row.  Both are a few operations per byte.
#include "rw_str.cuh"

__global__ void str_cmp_kernel(RwStr a, RwStr b, int op, long long n,
                               uint8_t* __restrict__ out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  const uint8_t* pa = rw_str_row(a, i);
  const uint8_t* pb = rw_str_row(b, i);
  const int la = rw_str_len(a, i), lb = rw_str_len(b, i);
  const int w = a.width > b.width ? a.width : b.width;
  int m = la > lb ? la : lb;
  if (m > w) m = w;
  int cmp = 0;
  for (int j = 0; j < m; ++j) {
    const int x = j < la ? (j < a.width ? pa[j] : 0) : -1;
    const int y = j < lb ? (j < b.width ? pb[j] : 0) : -1;
    if (x != y) {
      cmp = x < y ? -1 : 1;
      break;
    }
  }
  bool r;
  switch (op) {
    case 0: r = cmp == 0; break;
    case 1: r = cmp != 0; break;
    case 2: r = cmp < 0; break;
    case 3: r = cmp <= 0; break;
    case 4: r = cmp > 0; break;
    default: r = cmp >= 0; break;
  }
  out[i] = r ? 1 : 0;
}

__global__ void str_case_kernel(RwStr a, int upper, long long n,
                                uint8_t* __restrict__ out) {
  const long long k = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (k >= n * a.width) return;
  const long long i = k / a.width;
  const int j = static_cast<int>(k - i * a.width);
  uint8_t c = rw_str_row(a, i)[j];
  if (upper) {
    if (c >= 'a' && c <= 'z') c = static_cast<uint8_t>(c - 32);
  } else {
    if (c >= 'A' && c <= 'Z') c = static_cast<uint8_t>(c + 32);
  }
  out[k] = c;
}

extern "C" int rw_str_cmp(RwStr a, RwStr b, int op, long long n, void* out,
                          void* stream) {
  if (n > 0) {
    str_cmp_kernel<<<rw_blocks(n, 256), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        a, b, op, n, static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rw_str_case_map(RwStr a, int upper, long long n, void* out,
                               void* stream) {
  if (n > 0 && a.width > 0) {
    str_case_kernel<<<rw_blocks(n * a.width, 256), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        a, upper, n, static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
