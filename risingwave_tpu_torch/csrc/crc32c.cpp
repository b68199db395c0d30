// crc32c (Castagnoli) of a host buffer: the checkpoint store's integrity
// trailers.  A host routine, compiled by nvcc with the kernels into its own
// shared library (no device code).
//
// The port's copy of rw_crc32c in native/rwtpu_codec.cpp (reflected
// polynomial 0x82F63B78, initial value ~0, final ~), which
// risingwave_tpu/storage/codec.py `crc32c` (:203) calls.  Where the CPU has
// SSE4.2 the same CRC comes from its crc32 instruction, 8 bytes at a time
// (the instruction computes exactly this reflected Castagnoli CRC);
// elsewhere, and for the last bytes, the table-driven loop.
//
// Bound: the host's single-core CRC rate; a full q8 checkpoint (~1 GB of
// npz) takes ~0.1 s with the instruction, ~2 s with the table.
#include <cstdint>
#include <cstring>

static uint32_t crc_table[256];
static bool crc_init_done = false;

static void crc_init() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
    crc_table[i] = c;
  }
  crc_init_done = true;
}

static uint32_t crc_tail(uint32_t c, const uint8_t* data, int64_t n) {
  for (int64_t i = 0; i < n; ++i) c = crc_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c;
}

#if defined(__x86_64__)
__attribute__((target("sse4.2"))) static uint32_t crc_hw(uint32_t c,
                                                        const uint8_t* data,
                                                        int64_t n,
                                                        int64_t* done) {
  uint64_t c64 = c;
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t w;
    std::memcpy(&w, data + i, 8);
    c64 = __builtin_ia32_crc32di(c64, w);
  }
  *done = i;
  return static_cast<uint32_t>(c64);
}
#endif

extern "C" uint32_t rw_crc32c(const uint8_t* data, int64_t n) {
  if (!crc_init_done) crc_init();
  uint32_t c = 0xFFFFFFFFu;
  int64_t done = 0;
#if defined(__x86_64__)
  if (__builtin_cpu_supports("sse4.2")) c = crc_hw(c, data, n, &done);
#endif
  c = crc_tail(c, data + done, n - done);
  return ~c;
}
