// Kernel K9: Nexmark bid generation (sm_90a).
//
// Replaces risingwave_tpu/connector/nexmark.py:249 `_bids_impl` with
// `_mix` (:63), `_rand` (:69), `_rand_unit` (:79), the id chaining
// (:91-126), `_next_price` (:128) and `_gather_str` (:189).  Every field of
// a bid is a counter-based hash of (event id, field stream), so one thread
// computes one row with native uint64 arithmetic (the plain PyTorch version
// emulates the unsigned shift and modulo in int64):
//   auction, bidder (hot-key chaining), price = rint(pow(10, u*6) * 100)
//   (rint: round half to EVEN, as jnp.round and torch.round do; CUDA's
//   round() would round halves away from zero), channel and url (bytes and
//   lengths copied from the codebooks), date_time, and the chunk's ops
//   (all Insert) and valid (all true) planes.
// Divisions and modulos of signed ids are floor divisions, as in jnp and
// torch (the ids are non-negative for a non-negative seed, where the two
// agree).
// Bound: bytes (per row 8 * 4 B of int64 columns, 16 + 40 B of string
// bytes, 8 B of lengths and 2 B of ops/valid written; nothing read but
// the small codebooks); about 40 integer ops and one pow per row.
#include "nexmark_common.cuh"

struct BidArgs {
  long long k0;             // ordinal of the chunk's first bid
  int cap;
  long long inter_event_us;
  long long base_time_us;
  long long seed;
  const uint8_t* channels;  // [n_channels, ch_w] codebook bytes
  const int* channel_lens;
  int n_channels, ch_w;
  const uint8_t* urls;      // [n_urls, url_w]
  const int* url_lens;
  int n_urls, url_w;
  long long* auction;       // [cap] outputs
  long long* bidder;
  long long* price;
  uint8_t* channel;         // [cap, ch_w]
  int* channel_len;
  uint8_t* url;             // [cap, url_w]
  int* url_len;
  long long* date_time;
  int8_t* ops;
  uint8_t* valid;
};

__global__ void bids_kernel(BidArgs a) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= a.cap) return;
  const long long k = a.k0 + i;
  const long long n = fdiv(k, BID_PROPORTION) * TOTAL_PROPORTION +
                      PERSON_PROPORTION + AUCTION_PROPORTION +
                      fmod_(k, BID_PROPORTION);
  const long long eid = n + a.seed * (1ll << 40);

  const bool hot = rand_int(eid, 1, HOT_AUCTION_RATIO) > 0;
  const long long hot_auction =
      fdiv(last_auction(n), HOT_AUCTION_RATIO) * HOT_AUCTION_RATIO;
  a.auction[i] = (hot ? hot_auction : next_auction(eid, 2)) + FIRST_AUCTION_ID;

  const bool hot_b = rand_int(eid, 3, HOT_BIDDER_RATIO) > 0;
  const long long hot_bidder =
      fdiv(last_person(n), HOT_BIDDER_RATIO) * HOT_BIDDER_RATIO + 1;
  a.bidder[i] = (hot_b ? hot_bidder : next_person(eid, 4)) + FIRST_PERSON_ID;

  a.price[i] = next_price(eid, 5);
  copy_str(a.channels, a.channel_lens, a.ch_w,
           rand_int(eid, 6, a.n_channels), a.channel, a.channel_len, i);
  copy_str(a.urls, a.url_lens, a.url_w, rand_int(eid, 7, a.n_urls), a.url,
           a.url_len, i);
  a.date_time[i] = a.base_time_us + n * a.inter_event_us;
  a.ops[i] = 0;
  a.valid[i] = 1;
}

extern "C" int rw_nexmark_bids(BidArgs args, void* stream) {
  if (args.cap > 0) {
    const int threads = 256;
    const int blocks = (args.cap + threads - 1) / threads;
    bids_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        args);
  }
  return static_cast<int>(cudaGetLastError());
}
