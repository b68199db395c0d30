// Kernel K9, auctions and persons: Nexmark auction and person generation
// (sm_90a).
//
// Replaces risingwave_tpu/connector/nexmark.py `_auctions_impl` (:279) and
// `_persons_impl` (:312) with the helpers of nexmark_common.cuh.  As for
// bids, every field is a counter-based hash of (event id, field stream),
// so one thread computes one row with native uint64 arithmetic.  A column
// is written only when its output pointer is set: the wrapper passes the
// columns a source's declared column list keeps (q8 reads id, seller,
// reserve, expires, date_time of an auction and id, name, date_time of a
// person), and the rest are neither computed nor stored.  `reserve` still
// needs `initial_bid`'s price, and a hot seller follows the reference's
// rule: (last person id // 100) * 100, for 99 auctions in 100.
//
// Bound: bytes written (auctions for q8: 5 int64 columns, ops and valid,
// 42 B a row; persons: 2 int64 columns, 24 + 4 B of name, 22 B more);
// about 60 integer ops and two pow calls per auction row.
#include "nexmark_common.cuh"

struct AuctionArgs {
  long long k0;  // ordinal of the chunk's first auction
  int cap;
  long long inter_event_us;
  long long base_time_us;
  long long seed;
  const uint8_t* items;  // [n_items, item_w] codebook
  const int* item_lens;
  int n_items, item_w;
  const uint8_t* descs;  // [n_descs, desc_w] codebook
  const int* desc_lens;
  int n_descs, desc_w;
  long long* id;         // [cap] outputs; null = not requested
  uint8_t* item;         // [cap, item_w]
  int* item_len;
  uint8_t* desc;         // [cap, desc_w]
  int* desc_len;
  long long* initial_bid;
  long long* reserve;
  long long* date_time;
  long long* expires;
  long long* seller;
  long long* category;
  int8_t* ops;
  uint8_t* valid;
};

__global__ void auctions_kernel(AuctionArgs a) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= a.cap) return;
  const long long k = a.k0 + i;
  const long long n = fdiv(k, AUCTION_PROPORTION) * TOTAL_PROPORTION +
                      PERSON_PROPORTION + fmod_(k, AUCTION_PROPORTION);
  const long long eid = n + a.seed * (1ll << 40);
  if (a.id) a.id[i] = last_auction(n) + FIRST_AUCTION_ID;
  if (a.initial_bid || a.reserve) {
    const long long initial = next_price(eid, 10);
    if (a.initial_bid) a.initial_bid[i] = initial;
    if (a.reserve) a.reserve[i] = initial + next_price(eid, 11);
  }
  if (a.seller) {
    const bool hot = rand_int(eid, 12, HOT_SELLER_RATIO) > 0;
    const long long hot_seller =
        fdiv(last_person(n), HOT_SELLER_RATIO) * HOT_SELLER_RATIO;
    a.seller[i] = (hot ? hot_seller : next_person(eid, 13)) + FIRST_PERSON_ID;
  }
  if (a.category) {
    a.category[i] = FIRST_CATEGORY_ID + rand_int(eid, 14, NUM_CATEGORIES);
  }
  const long long ts = a.base_time_us + n * a.inter_event_us;
  if (a.date_time) a.date_time[i] = ts;
  if (a.expires) {
    a.expires[i] = ts + (rand_int(eid, 15, 4) + 1) * a.inter_event_us *
                            TOTAL_PROPORTION * 2;
  }
  if (a.item) {
    copy_str(a.items, a.item_lens, a.item_w, rand_int(eid, 16, a.n_items),
             a.item, a.item_len, i);
  }
  if (a.desc) {
    copy_str(a.descs, a.desc_lens, a.desc_w, rand_int(eid, 17, a.n_descs),
             a.desc, a.desc_len, i);
  }
  a.ops[i] = 0;
  a.valid[i] = 1;
}

extern "C" int rw_nexmark_auctions(AuctionArgs args, void* stream) {
  if (args.cap > 0) {
    const int threads = 256;
    const int blocks = (args.cap + threads - 1) / threads;
    auctions_kernel<<<blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}

// one string field of a person: its codebook, the output and the stream
struct StrField {
  const uint8_t* book;  // [n, w]
  const int* lens;
  int n, w;
  uint8_t* out;         // [cap, w]; null = not requested
  int* out_len;
};

struct PersonArgs {
  long long k0;  // ordinal of the chunk's first person
  int cap;
  long long inter_event_us;
  long long base_time_us;
  long long seed;
  StrField name, email, card, city, state;  // streams 20 .. 24
  long long* id;                            // [cap]; null = not requested
  long long* date_time;
  int8_t* ops;
  uint8_t* valid;
};

__device__ __forceinline__ void person_str(const StrField& f, long long eid,
                                           int stream, long long row) {
  if (f.out) {
    copy_str(f.book, f.lens, f.w, rand_int(eid, stream, f.n), f.out,
             f.out_len, row);
  }
}

__global__ void persons_kernel(PersonArgs a) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= a.cap) return;
  const long long n = (a.k0 + i) * TOTAL_PROPORTION;
  const long long eid = n + a.seed * (1ll << 40);
  if (a.id) a.id[i] = last_person(n) + FIRST_PERSON_ID;
  person_str(a.name, eid, 20, i);
  person_str(a.email, eid, 21, i);
  person_str(a.card, eid, 22, i);
  person_str(a.city, eid, 23, i);
  person_str(a.state, eid, 24, i);
  if (a.date_time) a.date_time[i] = a.base_time_us + n * a.inter_event_us;
  a.ops[i] = 0;
  a.valid[i] = 1;
}

extern "C" int rw_nexmark_persons(PersonArgs args, void* stream) {
  if (args.cap > 0) {
    const int threads = 256;
    const int blocks = (args.cap + threads - 1) / threads;
    persons_kernel<<<blocks, threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}
