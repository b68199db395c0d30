// Kernel K23b: to_char(timestamp, 'format') (sm_90a).
//
// Replaces risingwave_tpu/expr/scalar.py:857 `eval_to_char` with the
// calendar it runs, `_civil_from_ts` (:641, Howard Hinnant's
// civil_from_days, shared with K23h in rw_cal.cuh), for a format compiled
// at bind time by
// `compile_to_char_pattern` (:835).
//
// The compiled format arrives by value as a segment program: a literal run
// (bytes from `lit`) or a field (a component and its digit count).  One
// thread per row computes the row's calendar once, with FLOOR division and
// modulo throughout as jnp does (a timestamp before 1970 has a negative day
// number and a positive time of day), then writes the fixed-width row:
//   - a numeric field writes digit j as floor(v / 10^(w-1-j)) mod 10, so a
//     year past 9999 keeps its low 4 digits and a negative year's digits
//     follow the floor arithmetic, as in the reference;
//   - HH / HH12 is the 12-hour clock, (h24 + 11) mod 12 + 1;
//   - AM / PM (am / pm) write "PM" from 12:00 on, else "AM".
// Every output byte is written; the lengths are the width (the wrapper
// fills them).
//
// Bound: bytes (8 B read and `width` B written a row); the calendar is
// ~40 integer operations, below the memory time at any realistic width.
#include "rw_cal.cuh"

#define RW_TOCHAR_SEGS 32
#define RW_TOCHAR_LIT 128

// Component codes (scalar.py `_TO_CHAR_FIELDS`); 0 is a literal run.
enum {
  TC_LIT = 0, TC_YEAR, TC_YEAR2, TC_MONTH, TC_DAY, TC_HOUR24, TC_HOUR12,
  TC_MINUTE, TC_SECOND, TC_MILLI, TC_MICRO, TC_MERIDIEM_UPPER,
  TC_MERIDIEM_LOWER
};

struct ToCharProg {
  int n;                      // segments
  int width;                  // output bytes a row
  int kind[RW_TOCHAR_SEGS];   // TC_*
  int arg[RW_TOCHAR_SEGS];    // a literal's offset in `lit`; a field's digits
  int len[RW_TOCHAR_SEGS];    // a literal's byte count
  unsigned char lit[RW_TOCHAR_LIT];
};

__global__ void to_char_kernel(const long long* __restrict__ ts, long long n,
                               ToCharProg prog, uint8_t* __restrict__ out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  const long long us = ts[i];
  const RwCivil c = rw_civil_from_us(us);
  const long long y = c.y, m = c.m, d = c.d;
  const long long in_day = rw_floor_mod(us, RW_DAY_US);
  const long long h24 = in_day / 3600000000LL;

  uint8_t* o = out + i * prog.width;
  int pos = 0;
  for (int s = 0; s < prog.n; ++s) {
    const int kind = prog.kind[s];
    if (kind == TC_LIT) {
      for (int j = 0; j < prog.len[s]; ++j) o[pos++] = prog.lit[prog.arg[s] + j];
      continue;
    }
    if (kind == TC_MERIDIEM_UPPER || kind == TC_MERIDIEM_LOWER) {
      const uint8_t base = kind == TC_MERIDIEM_UPPER ? 0 : 32;
      o[pos++] = static_cast<uint8_t>((h24 >= 12 ? 'P' : 'A') + base);
      o[pos++] = static_cast<uint8_t>('M' + base);
      continue;
    }
    long long v;
    switch (kind) {
      case TC_YEAR: v = y; break;
      case TC_YEAR2: v = rw_floor_mod(y, 100); break;
      case TC_MONTH: v = m; break;
      case TC_DAY: v = d; break;
      case TC_HOUR24: v = h24; break;
      case TC_HOUR12: v = (h24 + 11) % 12 + 1; break;
      case TC_MINUTE: v = (in_day / 60000000LL) % 60; break;
      case TC_SECOND: v = (in_day / 1000000LL) % 60; break;
      case TC_MILLI: v = (in_day / 1000LL) % 1000; break;
      default: v = in_day % 1000000LL; break;  // TC_MICRO
    }
    const int w = prog.arg[s];
    long long p = 1;
    for (int j = 1; j < w; ++j) p *= 10;
    for (int j = 0; j < w; ++j, p /= 10) {
      o[pos++] = static_cast<uint8_t>('0' + rw_floor_mod(rw_floor_div(v, p), 10));
    }
  }
}

extern "C" int rw_to_char(const void* ts, long long n, ToCharProg prog,
                          void* out, void* stream) {
  if (n > 0 && prog.width > 0) {
    to_char_kernel<<<rw_blocks(n, 256), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(ts), n, prog,
        static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
