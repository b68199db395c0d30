// Kernel K23e: replace(s, from, to) (sm_90a).
//
// Replaces risingwave_tpu/expr/scalar.py:771 `_replace` with the helpers it
// runs: `_greedy_starts` (:709, a lax.scan over the byte width), `_match_at`
// (:592) and `_cover_mask` (:734, twice: the input's matched spans and the
// output's replacement spans).
//
// One thread per row walks the string once.  The matches of `from` are the
// leftmost non-overlapping ones (rw_str.cuh's `rw_next_match`: after a match
// at b the search resumes at b + len(from), so 'aa' occurs once in 'aaa');
// an empty `from` matches nothing and the row is copied.  Each match writes
// `to`'s bytes, every other byte of the string is copied, and the output is
// CLAMPED at the input's width, as the reference's scatter drops what lands
// past it (the deviation CONFORMANCE.md records): a `to` longer than `from`
// near a full row truncates, and the length is min(total, width).  The row
// is zero-filled past its length and written whole.  `from` and `to` are
// per-row inputs with their own row strides (0 for a literal).
//
// Bound: bytes.  A row's active bytes are read (the search re-reads a
// match's bytes from the same 16-byte words) and width + 4 bytes written;
// the compares are a few operations a byte.  At q14's 8192 x 40 B urls
// with a one-byte `from` that is ~0.7 MB a launch.
#include "rw_str.cuh"

__global__ void replace_kernel(RwStr a, RwStr f, RwStr t, long long n,
                               uint8_t* __restrict__ out,
                               int32_t* __restrict__ out_len) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  RwReader s(rw_str_row(a, i));
  RwReader from(rw_str_row(f, i));
  RwReader to(rw_str_row(t, i));
  const int ls = rw_str_len(a, i), lf = rw_str_len(f, i);
  const int lt = rw_str_len(t, i);
  RwWriter o(out + i * a.width, a.width);
  long long total = 0;  // the unclamped output length
  int next = lf > 0 ? rw_next_match(s, ls, from, lf, 0) : -1;
  for (int b = 0; b < ls;) {
    if (b == next) {
      for (int j = 0; j < lt && o.pos < a.width; ++j) o.put(to[j]);
      total += lt;
      b += lf;
      next = rw_next_match(s, ls, from, lf, b);
    } else {
      if (o.pos < a.width) o.put(s[b]);
      ++total;
      ++b;
    }
  }
  o.finish();
  out_len[i] = static_cast<int32_t>(total < a.width ? total : a.width);
}

extern "C" int rw_replace(RwStr a, RwStr f, RwStr t, long long n, void* out,
                          void* out_len, void* stream) {
  if (n > 0) {
    replace_kernel<<<rw_blocks(n, 128), 128, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        a, f, t, n, static_cast<uint8_t*>(out),
        static_cast<int32_t*>(out_len));
  }
  return static_cast<int>(cudaGetLastError());
}
