// The proleptic Gregorian calendar of the calendar kernels K23b and K23h
// (sm_90a): Howard Hinnant's civil_from_days over int64 microsecond
// timestamps, as risingwave_tpu/expr/scalar.py:641 `_civil_from_ts` runs it,
// with FLOOR division and modulo throughout (a time before 1970 has a
// negative day number and a non-negative time of day).
#pragma once

#include "rw_str.cuh"

#define RW_DAY_US 86400000000LL

struct RwCivil {
  long long days;  // floor(us / day)
  long long y, m, d;
};

__device__ __forceinline__ RwCivil rw_civil_from_us(long long us) {
  RwCivil c;
  c.days = rw_floor_div(us, RW_DAY_US);
  const long long z = c.days + 719468;
  const long long era = rw_floor_div(z, 146097);
  const long long doe = z - era * 146097;  // [0, 146096]: / floors here
  const long long yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
  const long long doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
  const long long mp = (5 * doy + 2) / 153;
  c.d = doy - (153 * mp + 2) / 5 + 1;
  c.m = mp < 10 ? mp + 3 : mp - 9;
  c.y = yoe + era * 400 + (c.m <= 2 ? 1 : 0);
  return c;
}
