// Kernel K23a: split_part(s, delimiter, n) (sm_90a).
//
// Replaces risingwave_tpu/expr/scalar.py:748 `_split_part` with the helpers
// it runs: `_match_at` (:592), `_greedy_starts` (:709, a lax.scan over the
// byte width) and `_cover_mask` (:734).
//
// One thread per row.  The delimiter's matches are the leftmost
// non-overlapping ones: the scan tries offsets 0 .. len(s) - len(d) and,
// after a match at b, resumes at b + len(d) (so 'aa' occurs twice in
// 'aaaa', not three times).  An empty delimiter matches nothing and the
// whole string is part 1.  With c matches there are c + 1 parts; n > 0
// picks part n - 1 (0-based), n <= 0 part c + 1 + n, and a part out of
// range is the empty string.  Part k runs from the end of match k - 1 (or
// 0) to the start of match k (or len(s)).  A first pass counts the matches,
// a second finds the target part's bounds; the part's bytes are written
// from offset 0 with zeros to the end of the row, and its length.  The
// delimiter and n are per-row inputs with their own row strides (0 for a
// literal), as the reference takes columns.
//
// The greedy walk is rw_str.cuh's `rw_next_match`, shared with K23e
// (replace); rows are read through 16-byte words (`RwReader`) and the
// output row is written whole (`RwWriter`).
//
// Bound: bytes.  Each row's string bytes are read (at most twice, from the
// same cache lines) and width + 4 bytes written; the match test is a few
// byte compares per offset.  At q22's 8192 x 40 B strings that is ~0.7 MB
// a launch, so the plain one-thread-per-row walk is the design.
#include "rw_str.cuh"

__global__ void split_part_kernel(RwStr a, RwStr d,
                                  const int32_t* __restrict__ nth,
                                  long long nth_stride, long long n,
                                  uint8_t* __restrict__ out,
                                  int32_t* __restrict__ out_len) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  RwReader s(rw_str_row(a, i));
  RwReader dp(rw_str_row(d, i));
  const int ls = rw_str_len(a, i), ld = rw_str_len(d, i);
  const long long k = nth[i * nth_stride];
  int count = 0;
  if (ld > 0) {
    for (int b = rw_next_match(s, ls, dp, ld, 0); b >= 0;
         b = rw_next_match(s, ls, dp, ld, b + ld)) {
      ++count;
    }
  }
  const long long target = k > 0 ? k - 1 : count + 1 + k;
  int start = 0, end = 0;
  if (target >= 0 && target <= count) {
    end = ls;
    long long part = 0;
    if (ld > 0) {
      for (int b = rw_next_match(s, ls, dp, ld, 0); b >= 0;
           b = rw_next_match(s, ls, dp, ld, b + ld)) {
        if (part == target) {
          end = b;
          break;
        }
        ++part;
        start = b + ld;
      }
    }
  }
  const int len = end - start;
  RwWriter o(out + i * a.width, a.width);
  for (int j = 0; j < len; ++j) o.put(s[start + j]);
  o.finish();
  out_len[i] = len;
}

extern "C" int rw_split_part(RwStr a, RwStr d, const void* nth,
                             long long nth_stride, long long n, void* out,
                             void* out_len, void* stream) {
  if (n > 0) {
    split_part_kernel<<<rw_blocks(n, 128), 128, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        a, d, static_cast<const int32_t*>(nth), nth_stride, n,
        static_cast<uint8_t*>(out), static_cast<int32_t*>(out_len));
  }
  return static_cast<int>(cudaGetLastError());
}
