// Kernel K23h: extract(part FROM ts) (sm_90a).
//
// Replaces risingwave_tpu/expr/scalar.py:659-701 `_mk_extract` (year,
// month, day, hour, minute, second, dow, doy over `_civil_from_ts` :641)
// and :399 / :404 `_extract_epoch`, over TIMESTAMP and TIMESTAMPTZ (int64
// microseconds) and DATE (int32 days, taken as days x 86400e6 us as the
// reference's `_mk_extract_date` does).  One entry for every part: `part`
// selects it, `days_in` the input's type.
//
// One thread per row: the calendar (rw_cal.cuh, shared with K23b) with
// FLOOR division and modulo, so a time before 1970 has a non-negative time
// of day; dow = (days + 4) mod 7 (1970-01-01 was a Thursday); doy = days -
// (days of Jan 1 of the year, from the inverse civil mapping) + 1; epoch =
// floor(us / 1e6).  Output int64.
//
// Bound: bytes (8 or 4 B read and 8 B written a row); the calendar is ~40
// integer operations, under the memory time on this card.
#include "rw_cal.cuh"

enum { CAL_YEAR = 0, CAL_MONTH, CAL_DAY, CAL_HOUR, CAL_MINUTE, CAL_SECOND,
       CAL_DOW, CAL_DOY, CAL_EPOCH };

__global__ void calendar_kernel(const void* __restrict__ in, int days_in,
                                int part, long long n,
                                long long* __restrict__ out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  const long long us =
      days_in ? static_cast<long long>(static_cast<const int32_t*>(in)[i]) *
                    RW_DAY_US
              : static_cast<const long long*>(in)[i];
  const long long in_day = rw_floor_mod(us, RW_DAY_US);
  long long v;
  switch (part) {
    case CAL_HOUR: v = in_day / 3600000000LL; break;
    case CAL_MINUTE: v = (in_day / 60000000LL) % 60; break;
    case CAL_SECOND: v = (in_day / 1000000LL) % 60; break;
    case CAL_EPOCH: v = rw_floor_div(us, 1000000LL); break;
    default: {
      const RwCivil c = rw_civil_from_us(us);
      if (part == CAL_YEAR) {
        v = c.y;
      } else if (part == CAL_MONTH) {
        v = c.m;
      } else if (part == CAL_DAY) {
        v = c.d;
      } else if (part == CAL_DOW) {
        v = rw_floor_mod(c.days + 4, 7);
      } else {  // CAL_DOY
        const long long yy = c.y - 1;
        const long long jan1 = yy * 365 + rw_floor_div(yy, 4) -
                               rw_floor_div(yy, 100) +
                               rw_floor_div(yy, 400) - 719162;
        v = c.days - jan1 + 1;
      }
    }
  }
  out[i] = v;
}

extern "C" int rw_calendar(const void* in, int days_in, int part,
                           long long n, void* out, void* stream) {
  if (n > 0) {
    calendar_kernel<<<rw_blocks(n, 256), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        in, days_in, part, n, static_cast<long long*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
