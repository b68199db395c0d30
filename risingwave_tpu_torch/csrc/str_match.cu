// Kernel K23f: starts_with, ends_with, contains and LIKE (sm_90a).
//
// Replaces risingwave_tpu/expr/scalar.py:609 `_starts_with`, :615
// `_ends_with` and :622 `_contains` over `_match_at` (:592), and :943
// `LikePattern.eval` (:908), the `%`-only LIKE the binder compiles when a
// pattern has an interior `%`.
//
// str_match: one thread per row; `mode` 0 starts_with, 1 ends_with, 2
// contains.  A pattern longer than the string never matches; an empty one
// always does.  contains takes the first offset that matches (the walk
// stops there).  The pattern is a per-row input with its own row stride (0
// for a literal).
//
// like: the pattern arrives by value as a program compiled at bind time:
// its non-empty `%`-separated segments (bytes and lengths) and whether the
// pattern is anchored at the start and at the end.  One thread per row runs
// the reference's leftmost-first sequential search: an anchored first
// segment must match at 0 and moves the cursor past it; an anchored last
// segment must match at len - its length, at or after the cursor; every
// other segment takes its first match at or after the cursor and moves the
// cursor past it.  A single segment anchored at both ends is an equality;
// no segment at all ('%', '%%') matches every row.  A failed segment ends
// the row's walk (the reference goes on, but its result is already false).
//
// Bound: bytes.  Each row reads its length and its bytes up to the decision
// (the whole string for an unmatched contains) and writes 1 B; the literal
// pattern stays in L1 or in the parameter bank.  A compare is a few
// operations a byte.
#include "rw_str.cuh"

#define RW_LIKE_SEGS 16
#define RW_LIKE_BYTES 256

struct LikeProg {
  int n;             // segments
  int anchor_start;  // the pattern does not start with '%'
  int anchor_end;    // the pattern does not end with '%'
  int off[RW_LIKE_SEGS];
  int len[RW_LIKE_SEGS];
  unsigned char bytes[RW_LIKE_BYTES];
};

__global__ void str_match_kernel(RwStr a, RwStr p, int mode, long long n,
                                 uint8_t* __restrict__ out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  RwReader s(rw_str_row(a, i));
  RwReader q(rw_str_row(p, i));
  const int ls = rw_str_len(a, i), lp = rw_str_len(p, i);
  bool r = false;
  if (lp <= ls) {
    if (mode == 0) {
      r = rw_eq_at(s, 0, q, lp);
    } else if (mode == 1) {
      r = rw_eq_at(s, ls - lp, q, lp);
    } else {
      r = rw_next_match(s, ls, q, lp, 0) >= 0;
    }
  }
  out[i] = r ? 1 : 0;
}

// Do the `n` program bytes at `off` occur in `s` at `at`?
__device__ __forceinline__ bool like_seg_at(RwReader& s, int at,
                                            const LikeProg& prog, int off,
                                            int n) {
  for (int j = 0; j < n; ++j) {
    if (s[at + j] != prog.bytes[off + j]) return false;
  }
  return true;
}

__global__ void like_kernel(RwStr a, LikeProg prog, long long n,
                            uint8_t* __restrict__ out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  RwReader s(rw_str_row(a, i));
  const int ls = rw_str_len(a, i);
  bool ok = true;
  if (prog.n == 1 && prog.anchor_start && prog.anchor_end) {
    ok = ls == prog.len[0] && like_seg_at(s, 0, prog, prog.off[0], ls);
  } else {
    int pos = 0;
    for (int k = 0; k < prog.n && ok; ++k) {
      const int off = prog.off[k], len = prog.len[k];
      if (k == 0 && prog.anchor_start) {
        ok = len <= ls && like_seg_at(s, 0, prog, off, len);
        pos = len;
      } else if (k == prog.n - 1 && prog.anchor_end) {
        const int at = ls - len;
        ok = at >= pos && like_seg_at(s, at, prog, off, len);
      } else {
        int hit = -1;
        for (int b = pos; b + len <= ls; ++b) {
          if (like_seg_at(s, b, prog, off, len)) {
            hit = b;
            break;
          }
        }
        ok = hit >= 0;
        pos = hit + len;
      }
    }
  }
  out[i] = ok ? 1 : 0;
}

extern "C" int rw_str_match(RwStr a, RwStr p, int mode, long long n,
                            void* out, void* stream) {
  if (n > 0) {
    str_match_kernel<<<rw_blocks(n, 128), 128, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        a, p, mode, n, static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rw_like(RwStr a, LikeProg prog, long long n, void* out,
                       void* stream) {
  if (n > 0) {
    like_kernel<<<rw_blocks(n, 128), 128, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        a, prog, n, static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
