// Kernel K23g: substr, trim / ltrim / rtrim and concat (sm_90a).
//
// Replaces risingwave_tpu/expr/scalar.py:527 `_substr_window` (under
// `_substr2` :548 and `_substr3` :554), :558 `_trim_side` (under `trim`,
// `ltrim` and `rtrim`, :578-588) and :509 `_concat` (also `||`).  Each is a
// per-row byte window of one or two strings copied from offset 0, zero-
// filled past its length; `mode` picks the function.
//
// One thread per row:
//   - substr (mode 0): PostgreSQL's window, which starts at the GIVEN,
//     possibly non-positive, position: s0 = start - 1, end = s0 +
//     max(count, 0) (or the width without a count), and the bytes
//     [max(s0, 0), min(end, len)) (substr('hello', -1, 3) = 'h').  The
//     int64 arithmetic wraps as jnp's does; start and count are per-row
//     int64 inputs with their own row strides (0 for a literal).
//   - trim (3), ltrim (1), rtrim (2): the bytes between the first and the
//     last non-space byte of the string (one side kept for ltrim / rtrim);
//     an all-space or empty string is empty.
//   - concat (4): a's bytes, then b's; the output width is the sum of the
//     two widths, so nothing truncates.
// Only a row's active bytes are read; its output row is written whole.
//
// Bound: bytes.  Each row reads its active bytes (trim: those up to the
// first and from the last non-space byte) and its lengths, and writes its
// output row and length; a few operations a byte.
#include "rw_str.cuh"

enum { WIN_SUBSTR = 0, WIN_LTRIM = 1, WIN_RTRIM = 2, WIN_TRIM = 3,
       WIN_CONCAT = 4 };

__global__ void str_window_kernel(RwStr a, RwStr b,
                                  const long long* __restrict__ start,
                                  long long start_stride,
                                  const long long* __restrict__ count,
                                  long long count_stride, int mode,
                                  long long n, int out_width,
                                  uint8_t* __restrict__ out,
                                  int32_t* __restrict__ out_len) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  RwReader s(rw_str_row(a, i));
  const int la = rw_str_len(a, i);
  RwWriter o(out + i * static_cast<long long>(out_width), out_width);
  if (mode == WIN_CONCAT) {
    RwReader t(rw_str_row(b, i));
    const int lb = rw_str_len(b, i);
    for (int j = 0; j < la; ++j) o.put(s[j]);
    for (int j = 0; j < lb; ++j) o.put(t[j]);
    o.finish();
    out_len[i] = la + lb;
    return;
  }
  long long lo, len;
  if (mode == WIN_SUBSTR) {
    const long long s0 = rw_wrap_sub(start[i * start_stride], 1);
    long long end = a.width;
    if (count != nullptr) {
      const long long c = count[i * count_stride];
      end = rw_wrap_add(s0, c > 0 ? c : 0);
    }
    lo = s0 > 0 ? s0 : 0;
    const long long hi = end < la ? end : la;
    const long long d = rw_wrap_sub(hi, lo);
    len = d > 0 ? d : 0;
  } else {
    int first = 0;
    while (first < la && s[first] == ' ') ++first;
    int last = la - 1;
    while (last >= first && s[last] == ' ') --last;
    if (first >= la) {
      lo = 0;
      len = 0;
    } else {
      lo = (mode & WIN_LTRIM) ? first : 0;
      const int e = (mode & WIN_RTRIM) ? last + 1 : la;
      len = e - lo;
    }
  }
  // the reference's int32 length and its clipped source index
  const int32_t len32 = static_cast<int32_t>(len);
  for (int j = 0; j < a.width && j < len32; ++j) {
    long long src = rw_wrap_add(j, lo);
    src = src < 0 ? 0 : (src > a.width - 1 ? a.width - 1 : src);
    o.put(s[src]);
  }
  o.finish();
  out_len[i] = len32;
}

extern "C" int rw_str_window(RwStr a, RwStr b, const void* start,
                             long long start_stride, const void* count,
                             long long count_stride, int mode, long long n,
                             int out_width, void* out, void* out_len,
                             void* stream) {
  if (n > 0) {
    str_window_kernel<<<rw_blocks(n, 128), 128, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        a, b, static_cast<const long long*>(start), start_stride,
        static_cast<const long long*>(count), count_stride, mode, n,
        out_width, static_cast<uint8_t*>(out),
        static_cast<int32_t*>(out_len));
  }
  return static_cast<int>(cudaGetLastError());
}
