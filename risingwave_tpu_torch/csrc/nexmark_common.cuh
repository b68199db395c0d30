// Shared pieces of the Nexmark generator kernels (nexmark_bids.cu,
// nexmark_events.cu): the proportions and id-chaining constants and the
// counter-based randomness of risingwave_tpu/connector/nexmark.py
// (`_mix` :63, `_rand` :69, `_rand_int`, `_rand_unit` :79, the id chaining
// :91-126, `_next_price` :128, `_gather_str` :189).  Divisions and modulos
// of signed ids are floor divisions, as in jnp and torch; `_next_price` is
// rint(pow(10, u * 6) * 100) (rint rounds half to even like jnp.round;
// CUDA's round() would round halves away from zero).
#pragma once

#include "rw_common.cuh"

static constexpr long long PERSON_PROPORTION = 1;
static constexpr long long AUCTION_PROPORTION = 3;
static constexpr long long BID_PROPORTION = 46;
static constexpr long long TOTAL_PROPORTION = 50;
static constexpr long long FIRST_PERSON_ID = 1000;
static constexpr long long FIRST_AUCTION_ID = 1000;
static constexpr long long HOT_AUCTION_RATIO = 100;
static constexpr long long HOT_BIDDER_RATIO = 100;
static constexpr long long HOT_SELLER_RATIO = 100;
static constexpr long long FIRST_CATEGORY_ID = 10;
static constexpr long long NUM_CATEGORIES = 5;
static constexpr long long ACTIVE_PEOPLE = 1000;
static constexpr long long IN_FLIGHT_AUCTIONS = 100;

__device__ __forceinline__ long long fdiv(long long x, long long m) {
  long long q = x / m;
  if ((x % m != 0) && ((x < 0) != (m < 0))) --q;
  return q;
}

__device__ __forceinline__ long long fmod_(long long x, long long m) {
  return x - fdiv(x, m) * m;
}

__device__ __forceinline__ uint64_t rand64(long long eid, int stream) {
  const uint64_t key = static_cast<uint64_t>(stream) * RW_K3;
  return rw_mix64((static_cast<uint64_t>(eid) * RW_K1) ^ key);
}

__device__ __forceinline__ long long rand_int(long long eid, int stream,
                                              long long bound) {
  return static_cast<long long>(rand64(eid, stream) %
                                static_cast<uint64_t>(bound));
}

__device__ __forceinline__ long long last_person(long long n) {
  const long long epoch = fdiv(n, TOTAL_PROPORTION);
  long long offset = fmod_(n, TOTAL_PROPORTION);
  if (offset > PERSON_PROPORTION - 1) offset = PERSON_PROPORTION - 1;
  return epoch * PERSON_PROPORTION + offset;
}

__device__ __forceinline__ long long last_auction(long long n) {
  long long epoch = fdiv(n, TOTAL_PROPORTION);
  long long offset = fmod_(n, TOTAL_PROPORTION);
  if (offset < PERSON_PROPORTION) {
    epoch -= 1;
    offset = AUCTION_PROPORTION - 1;
  } else {
    offset -= PERSON_PROPORTION;
    if (offset > AUCTION_PROPORTION - 1) offset = AUCTION_PROPORTION - 1;
  }
  return epoch * AUCTION_PROPORTION + offset;
}

__device__ __forceinline__ long long next_person(long long eid, int stream) {
  const long long num_people = last_person(eid) + 1;
  const long long active =
      num_people < ACTIVE_PEOPLE ? num_people : ACTIVE_PEOPLE;
  long long r = rand_int(eid, stream, ACTIVE_PEOPLE + 1);
  if (r > active) r = active;
  return num_people - active + r;
}

__device__ __forceinline__ long long next_auction(long long eid, int stream) {
  const long long max_a = last_auction(eid);
  const long long min_a =
      max_a - IN_FLIGHT_AUCTIONS > 0 ? max_a - IN_FLIGHT_AUCTIONS : 0;
  const long long span = max_a - min_a + 1;
  return min_a + static_cast<long long>(rand64(eid, stream) %
                                        static_cast<uint64_t>(span));
}

__device__ __forceinline__ long long next_price(long long eid, int stream) {
  const double u = static_cast<double>(rand64(eid, stream) >> 11) /
                   9007199254740992.0;  // 2^53
  return static_cast<long long>(rint(pow(10.0, u * 6.0) * 100.0));
}

__device__ __forceinline__ void copy_str(const uint8_t* book, const int* lens,
                                         int w, long long idx, uint8_t* out,
                                         int* out_len, long long row) {
  const uint8_t* src = book + idx * w;
  uint8_t* dst = out + row * w;
  for (int j = 0; j < w; ++j) dst[j] = src[j];
  out_len[row] = lens[idx];
}
