#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the hand-written CUDA kernels from ``risingwave_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel) and prints the build time;
2. holds each kernel against its plain PyTorch version on the card at
   the shapes the Nexmark q1/q5/q7/q8 main paths give it (8192-row
   chunks, 2^18-slot tables, 2^23-row ring, 5x hop expansion of the pane
   deltas; for q8 the join state of a bench-size q8 engine after 10
   barriers, two 2^22-slot tag tables, and its next auction chunk; for
   K11 and K4 the whole state tree of a bench-size q8 engine, ~1 GB),
   requiring exact equality (tags bit for bit), and times kernel, plain
   version, one PyTorch library call where one exists, and the card's
   bound for the same bytes; K8-ring on every ``k8_ring_cases`` case,
   at q1's and q22's (176 B string rows) shapes and on a 2^18-row
   backfill chunk that wraps a 2^19 ring; for the top-N kernels K16-K18
   the TopN state of a q19 engine (pool 2^18, emitted band 2^16) and its
   next 8192-row chunks, K16 on every ``k16_cases`` script and on a wide
   case (2^19-row chunks into a 2^23 pool: every block's rows and slots
   over several tiles), its delete branches on a retractable chunk at a
   2^14 pool and its time at ow_bid's shape (an 8192-bid chunk into a
   2^22 pool with 2,818,048 live), K18 on every ``k18_cases`` case and
   its membership at ow_bid's shape (2 x 2^22 entries, 2,818,048 live,
   ~1% changed), K1 on bid rows with random bytes past
   the strings' lengths and K3 on the MV's whole-row key (strings included); for
   the over-window K20 on synthetic pools of every window call kind at
   both window queries' pool shapes (2^18 / emit 2^16 and 2^22 / 2^22:
   90% of the rows in one partition, tie-heavy negative keys, ROWS
   frames) and on every ``k20_cases`` case (two flushes each) against
   the plain version on a CPU copy, K20 and K19a on the
   over-window state of a q6_bid engine, K16 timed on the over-window's
   input (the top-N's [2E] flush chunk), and K1/K3 on float keys (-0.0,
   NaNs, infinities, subnormals; the MV key with q6_bid's float64 avg);
   for the join matrix, on the state of a q101 engine (auctions in a
   2^22 pool, the aggregation's output in 2^18 x 64 dense buckets) K13d
   on the aggregation's U-/U+ flush, K14 over the dense build (an
   auction chunk: pairs and NULL pads) and over the pool build (the
   flush: pads retracted, pairs), the spill capture on both of the
   agg's branches with a 4-slot table (the ring fills and overflows),
   and a dense side's clean_below and rebuild, each against its plain
   version on CPU copies; then every join type over dense/dense,
   pool/dense and pool/pool sides with strings, NULLs, duplicates,
   annihilating pairs, unmatched deletes and full buckets, window by
   window and state by state, against the CPU; for q102, on the state
   of a q102 engine (the filter's pool and the dedup table at 2^18),
   K6d on a bid chunk and on its inverse (keys retracted to 0), the K4
   sweep by slot list and by predicate over the dedup table and the
   join's tag table, K5 on a join window keyed (int64, VARCHAR) and with
   hashes forced equal, K16 and K21's left pass on the aggregation's
   flush into the filter's pool, and K21's right pass with the
   threshold up, down, emptied and set again; for q13, K22a on 8192 bids
   probing ``auction % 10000`` in a 2^14-slot build table of 10,000 keys
   and on ``k22_cases``' edge cases (NULL keys, misses, tombstones,
   VARCHAR(8) keys with bytes past their lengths, a two-column key, inner
   and left outer pads, a full table whose probes overflow), every output
   leaf, the valid plane and the overflow count exact; K23e-h (replace,
   starts_with / ends_with / contains and LIKE, substr / trims / concat,
   extract) on 8192 rows of ``k23_rest_cases`` (greedy overlaps, replace's
   clamp, every LIKE of ``K23F_LIKE``, PostgreSQL's substr windows,
   strings around spaces, timestamps from 1600 to 2400 and dates) and on
   a bid chunk, exact against the plain versions and equal to Python's
   bytes methods, ``re`` and ``datetime``;
3. runs q7, q5 and q1 at 2 events/s, q8 at 10,000 events/s and q19,
   q18, q6_bid and ow_bid at 2 events/s through the port's ``Engine``
   on the card and on the CPU (plain versions, the agg forced onto the
   card's pre-aggregation branch) and requires equal MV or ring rows
   and equal state, slot for slot; q101, q103 and q104 at 10,000
   events/s with a 16-slot agg table (its spill ring and host tier run),
   then ``recover()`` and 2 more barriers, with equal tiers too, and
   q102 the same way; q22, q10 and q21 at 2 events/s (equal ring rows
   and state); q13 and its LEFT JOIN with churn (500 keys, chunk 256:
   equal ring rows, build table and counters); q14, bid_strings and
   avg_bid at 2 events/s (equal MV rows and state);
4. runs q1, q5, q7, q8, q19, q18, q6_bid and ow_bid, each in a fresh
   ``Engine`` at ``bench.py``'s sizes (q19/q18/q6_bid with a top-N pool
   of 2^18, an emitted band of 2^16 and an MV table of 2^18; ow_bid
   with an over-window pool and emit capacity of 2^22 and an MV table
   of 2^23; q101, q103 and q104 with join tables of 2^22 / 2^18, bucket
   64, a pool of 2^22 and an MV of 2^22; q102 the same with a filter
   pool and an MV of 2^18; 9 warm-up barriers, then 32
   timed barriers of 8 chunks, or of 8 scheduling rounds of 1 person and
   3 auction chunks for q8, or of one auction and one bid chunk for the
   join queries, and of an auction chunk and a chunk from each bid
   reader for q102; q22, q10 and q21 with a ring of 2^23, which their
   2.69M bids do not lap; q13 with 10,000 INSERTed keys and the ring at
   2^23, and q13 churn, its LEFT JOIN over a retractable table with 128
   UPDATEs and 16 DELETEs before each timed barrier, rows/s counting bid
   rows only; q14 and bid_strings with a ring of 2^23, avg_bid with an
   agg table and an MV of 2^18) with the launch counters set to 0 just before and read
   just after each timed window, and requires every kernel of that
   query's path to have launched; then q6_bid with the over-window's
   watermark cleaning set on the executor (8 timed barriers: K19a on
   the path);
5. checks each MV against a numpy recomputation over the events the
   port generated: q7's max(price) and count(*) per 10-second window,
   q5's bid count per (auction, hop window), q1's ring rows, q8's ring
   as the inner join of persons and auctions on id = seller within a
   1-second window, q19's top-10 prices per auction with ranks 1..k,
   q18's latest bid per (bidder, auction), q6_bid's top-1 bid per
   auction with each bidder's 11-row moving average, and ow_bid's
   per-auction window values, every row a consumed bid; for the top-N
   and over-window paths also the overflow and inconsistency counters
   (0) and the band or pool at every flush (within the emitted
   capacity: lossless); q101's MV as every auction with its bids' max
   (NULL without bids), q103's as the auctions with at least 20 bids,
   q104's as those with none or at least 20, with the joins' and the
   agg's loss counters 0 and the spill ring empty; q102's as each
   auction's joined bid count where it reaches the floor division of all
   bids by their distinct auctions (the card's threshold equal to
   numpy's), with the join's, both aggregations' (their dedup included)
   and the filter's loss counters 0; q22's ring as url.split('/') parts
   4-6, q10's as strftime('%Y-%m-%d') and '%I:%M', q21's as the four-way
   channel map with every bid kept, leaf for leaf (zero tails, lengths,
   the null plane); q13's as every bid with the text of ``auction %
   10000``, q13 churn's as every bid with the value a host model of the
   table held when the DAG probed it (a deleted key a NULL pad), and the
   churn run against the same run on the CPU, tensor for tensor; q14's
   ring as the bids kept by 0.908 * price (NUMERIC) with the CASE of the
   hour and url.count('e'), bid_strings' as the bids LIKE and the ORs
   keep with Python's slices, concats and strips, datetime's year and
   day of year and the two divides, and avg_bid's MV as each auction's
   float64 avg (within 1e-12 relative), truncated NUMERIC avg and count;
6. runs q7, q8, q19 and q13 churn durably (``Engine(config,
   data_dir=<temporary directory>)``, the same sizes and barriers, a
   snapshot every 8 checkpoints through K11 and the background uploader;
   q13's cold start reloads the DML journal and replays the lost
   barrier's DML), prints rows/s,
   each checkpoint's kind, bytes and dirty share, K11's device time per
   snapshot and the uploader stall, then cold-starts a new engine from
   the directory, runs 8 more barriers and requires every state tensor
   to equal an engine that ran the same barriers without stopping; the
   directory is deleted;
7. holds K22b (the sink ring) against its plain version on every leaf
   kind across a ring wrap and on a 2^18-row backfill chunk, and K19b
   (the append-only dedup: K1, K3, the K4 sweep) against a CPU copy
   through a watermark eviction and a rehash; then runs ``q1_sink`` (q1
   into a blackhole sink, ring 2^23: the ring read back equals numpy's
   q1, the blackhole counts every row in one commit a snapshot barrier),
   ``q5_cascade`` (q5, 4 barriers, then ``q5_hot`` = q5's rows with
   ``bids >= T``, T the least count keeping at most half of q5's rows,
   backfilled from q5's 2^18-slot table, and a file sink over it; q5 and
   q5_hot against numpy, the file's fold against q5_hot with one data
   line per ring row; then DROP MATERIALIZED VIEW q5 refused, DROP SINK
   and DROP MATERIALIZED VIEW q5_hot, SHOW at each step, and q5 still
   equal to numpy a barrier later), the same durable (the engine dropped
   without a stop, a cold start, 4 more barriers, exactly once) and
   ``dedup_sink`` (bids at 100,000 events/s, a 10 s TUMBLE, the dedup on
   (window_start, auction) in 2^16 slots, a blackhole sink: the ring
   equals numpy's first bid per pair; the watermark's sweep and the
   rehash must run), each with rows/s, launches, busy share, K22b's
   profiled ms and bound, ``deliver``'s host ms and the backfills' ms;
8. holds K22c (the partial aggregation), K2 (the vnode hash, its CRC
   also against ``zlib.crc32``) and K24 (the hash exchange) against their
   plain versions on edge-case chunks (every key and argument kind,
   retractions, NULLs, invalid rows) and on one chunk round of bench's q5
   and q7 over 4 lanes (every plane of every lane, exact); then runs q5
   and q7 sharded over 4 lanes through SQL (``Engine(..., lanes=4)``,
   ``SET streaming_parallelism = 4``) at bench.py's sizes with launch
   counters, each MV against numpy and against the port's linear run over
   the same bids, and both durably with a cold start checked tensor for
   tensor against the engine that never stopped;
9. holds K11 lanes (the shadow update and the delta's gather over the
   lane grid) against its plain version on the stacked state tree of a
   bench-size q8 engine sharded over 4 lanes (~4.2 GB), exactly; then runs
   bench's q8 sharded over 4 lanes through SQL (``SET
   streaming_parallelism = 4``) with launch counters, the lanes' rings
   against numpy (each lane's watermark filter on its own blocks) and
   against the port's linear q8 over the same chunks, every loss counter
   0, and durably (a full snapshot, a lane delta, a cold start checked
   tensor for tensor against the engine that never stopped);
10. holds K25 (the vnode gate, on 8192-row chunks with U-/U+ pairs at
   both edges), K26 (the vnode sweep) and K27 (the transplant scatter) on
   a 2^18-slot aggregation table, an MV table and a dense join side, and
   K28 (the troublemaker) against their plain versions, exactly; runs
   both scale scenarios of the CPU tests at their small sizes on the card
   against the CPU; then the vnode scale plane at bench.py's sizes:
   ``scale_agg`` (the per-auction count, sum and max over bids without a
   watermark, 64 vnodes, partitions 2 -> 4 -> 2, 24 barriers) and
   ``scale_join`` (``ja LEFT JOIN jb`` at q13's DML scale, 2 -> 4 -> 2),
   each partition a ``role="compute"`` engine over one shared store, with
   launch counters: the union of the partitions against numpy and the
   port's linear engine, gate_dropped and every handover's cleared and
   moved entries against a numpy model, every loss counter 0, rows/s and
   the handover's milliseconds; and the troublemaker feeding a join side
   on the card against the CPU;
11. prints the ``kernels`` JSON line, the card's name and power limit,
   and as its last line ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without the ok line.  Without a GPU, or
outside a checkout of the repository, it exits with code 2.
``--rehearse`` runs the same phases on the CPU at a small size (plain
versions on both sides, no timings worth keeping, no ok line).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: the card's peak rates (NVIDIA H100 SXM data sheet, dense): HBM bytes/s
#: and the scalar (non-tensor-core) 32-bit rate used for integer work
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

#: bench.py's PlannerConfig for the three queries (ring 2^23 for q1)
BENCH_CONFIG = dict(chunk_capacity=8192, agg_table_size=1 << 18,
                    agg_emit_capacity=4096, mv_table_size=1 << 18)
WARMUP_BARRIERS = 9
BARRIERS = 32
CHUNKS_PER_BARRIER = 8
WINDOW_US = 10_000_000
HOP_SLIDE_US = 2_000_000
QUERIES = ("q1", "q5", "q7", "q8", "q19", "q18", "q6_bid", "ow_bid",
           "q101", "q103", "q104", "q102", "q22", "q10", "q21", "q13",
           "q13 churn", "q14", "bid_strings", "avg_bid", "q5_max", "q7_eowc",
           "person_states")
#: the kernels each query's main path must launch
PATH_KERNELS = {
    "q1": ("nexmark_bids", "ring_append"),
    "q5": ("nexmark_bids", "hop_window", "hash64", "agg_preagg", "probe",
           "agg_scatter", "mask_indices", "mv_upsert"),
    "q7": ("nexmark_bids", "hop_window", "hash64", "agg_preagg", "probe",
           "agg_scatter", "mask_indices", "mv_upsert"),
    "q8": ("nexmark_auctions", "nexmark_persons", "hop_window", "hash64",
           "tag_insert_ranked", "tag_probe", "join_update", "join_emit",
           "join_clean", "mask_indices", "ring_append", "permute_rows"),
    "q19": ("nexmark_bids", "hash64", "topn_pool", "topn_band",
            "mask_indices", "topn_flush", "probe", "mv_upsert"),
    "q18": ("nexmark_bids", "hash64", "topn_pool", "topn_band",
            "mask_indices", "topn_flush", "probe", "mv_upsert"),
    "q6_bid": ("nexmark_bids", "hash64", "topn_pool", "topn_band",
               "mask_indices", "topn_flush", "over_window", "probe",
               "mv_upsert"),
    "ow_bid": ("nexmark_bids", "hash64", "topn_pool", "topn_band",
               "topn_flush", "over_window", "probe", "mv_upsert"),
    # the join matrix on retractable inputs: auctions in a pool, the
    # aggregation's output (with its spill capture) in dense buckets
    "q101": ("nexmark_bids", "nexmark_auctions", "hash64", "agg_preagg",
             "probe", "agg_scatter", "agg_spill", "mask_indices",
             "tag_insert_ranked", "tag_probe", "join_update", "join_dense",
             "join_emit", "mv_upsert"),
    "q103": ("nexmark_bids", "nexmark_auctions", "hash64", "agg_preagg",
             "probe", "agg_scatter", "agg_spill", "mask_indices",
             "tag_insert_ranked", "tag_probe", "join_update", "join_dense",
             "join_emit", "mv_upsert"),
    "q104": ("nexmark_bids", "nexmark_auctions", "hash64", "agg_preagg",
             "probe", "agg_scatter", "agg_spill", "mask_indices",
             "tag_insert_ranked", "tag_probe", "join_update", "join_dense",
             "join_emit", "mv_upsert"),
    # an aggregation over a pool/pool join, COUNT(DISTINCT) in the
    # scalar's global aggregation, the dynamic filter over a row pool
    "q102": ("nexmark_bids", "nexmark_auctions", "hash64", "agg_preagg",
             "probe", "agg_scatter", "agg_spill", "mask_indices",
             "tag_insert_ranked", "tag_probe", "join_update", "join_emit",
             "agg_distinct", "table_sweep", "topn_pool", "dyn_filter",
             "mv_upsert"),
    # string and calendar expressions into the append-only ring
    "q22": ("nexmark_bids", "str_split_part", "ring_append"),
    "q10": ("nexmark_bids", "to_char", "ring_append"),
    "q21": ("nexmark_bids", "str_case_map", "str_cmp", "regexp_group",
            "ring_append"),
    # the temporal join into the ring (K1 hashes the probe keys); with
    # churn the build table takes UPDATEs and DELETEs (K3, K8)
    "q13": ("nexmark_bids", "hash64", "temporal_probe", "ring_append"),
    "q13 churn": ("nexmark_bids", "hash64", "temporal_probe", "probe",
                  "mv_upsert", "ring_append"),
    # scalar functions: q14's calendar (extract hour, four times) and
    # replace (the count_char UDF); bid_strings' LIKE family, substr,
    # trims, concats and date parts; avg_bid's avg over the q7 agg path
    # (no window: the spill capture runs)
    "q14": ("nexmark_bids", "calendar", "str_replace", "ring_append"),
    "bid_strings": ("nexmark_bids", "str_match", "str_window", "calendar",
                    "ring_append"),
    "avg_bid": ("nexmark_bids", "hash64", "agg_preagg", "probe",
                "agg_scatter", "agg_spill", "mask_indices", "mv_upsert"),
    # q5's pane plan with max(price): the global agg's materialized input
    # (K6m's update with K1 on the (slot, value) pairs and K13's ranks,
    # and its refresh at flush)
    "q5_max": ("nexmark_bids", "hop_window", "hash64", "agg_preagg", "probe",
               "agg_scatter", "agg_minput", "join_update", "mask_indices",
               "minput_refresh", "mv_upsert"),
    # EMIT ON WINDOW CLOSE: K7e picks the closed groups, the K4 sweep
    # evicts them, the ring takes the final rows
    "q7_eowc": ("nexmark_bids", "hop_window", "hash64", "agg_preagg",
                "probe", "agg_scatter", "agg_eowc", "table_sweep",
                "ring_append"),
    # packed string min/max over person rows, grouped by a string key (no
    # window: the spill capture runs)
    "person_states": ("nexmark_persons", "hash64", "agg_preagg", "probe",
                      "agg_scatter", "agg_spill", "mask_indices",
                      "mv_upsert"),
    # q6_bid with the over-window's watermark cleaning set on the
    # executor (no plan sets it): K19a on the path
    "q6_bid clean": ("nexmark_bids", "hash64", "topn_pool", "topn_band",
                     "mask_indices", "topn_flush", "over_window",
                     "topn_clean", "probe", "mv_upsert"),
}
#: the durable main paths (``Engine(config, data_dir=...)``) add K11: the
#: shadow update, and the gather of every delta checkpoint (q7's hot
#: window leaves most blocks clean, so its epochs are deltas)
DURABLE_KERNELS = {
    "q7": PATH_KERNELS["q7"] + ("shadow_digest", "dirty_gather"),
    "q8": PATH_KERNELS["q8"] + ("shadow_digest",),
    "q19": PATH_KERNELS["q19"] + ("shadow_digest",),
    "q13": PATH_KERNELS["q13 churn"] + ("shadow_digest",),
}


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(code)


#: device cycles per millisecond used to size the queue pre-fill (the
#: H100 SXM's 1980 MHz boost clock; a slower clock only sleeps longer)
CYCLES_PER_MS = 1.98e6
#: host time per call the pre-fill covers (wrappers take ~20-500 us)
PREFILL_MS_PER_CALL = 1.0


class Timer:
    """Mean milliseconds per call of ``fn(i)`` over ``iters`` calls:
    CUDA events on the card, the host clock in a CPU rehearsal.

    On the card a sleep kernel first fills the stream, so the calls are
    queued behind it and the events time the device's work, not the
    host's launch gaps (a call that synchronises still pays for its
    wait).  A timing whose enqueue outlasted the sleep includes host
    time, and a ``[timer]`` line before the phase's result says so."""

    def __init__(self, torch, device):
        self.torch = torch
        self.cuda = device.type == "cuda"

    def __call__(self, fn, iters: int,
                 prefill_ms: float = PREFILL_MS_PER_CALL) -> float:
        torch = self.torch
        fn(iters)  # warm up (and build on first use) on its own input
        if self.cuda:
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            sleep_ms = min(iters * prefill_ms, 200.0)
            torch.cuda._sleep(int(sleep_ms * CYCLES_PER_MS))
            t0 = time.perf_counter()
            e0.record()
            for i in range(iters):
                fn(i)
            e1.record()
            host_ms = (time.perf_counter() - t0) * 1e3
            if host_ms > sleep_ms:
                print(f"[timer] {iters} calls took {host_ms:.1f} ms to "
                      f"enqueue, past the {sleep_ms:.0f} ms pre-fill: their "
                      "time, reported below, includes host time", flush=True)
            torch.cuda.synchronize()
            return e0.elapsed_time(e1) / iters
        # a rehearsal's timings are worth nothing: one call
        t0 = time.perf_counter()
        fn(0)
        return (time.perf_counter() - t0) * 1e3


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_name(key: str) -> str:
    """A profiler event's CUDA function name without the ``void`` that the
    demangler puts before a template instance (``void
    preagg_kernel<3>(PreaggArgs)``)."""
    return key[5:] if key.startswith("void ") else key


def device_ms_by_kernel(torch, device, fn, iters: int,
                        names) -> dict | None:
    """Mean device milliseconds a call of ``fn(i)`` spends in the CUDA
    functions whose names start with each of ``names``, over ``iters``
    calls under torch.profiler (after a warm-up call on input ``iters``);
    None off the card or when the profiler recorded no device time."""
    if device.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(iters)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        for name in names:
            if kernel_name(e.key).startswith(name):
                out[name] += us / 1e3 / iters
    return out if any(out.values()) else None


def pool_apply_bound(cap: int, row: float, n_del: int, n_ins: int,
                     scanned: int) -> tuple[float, str]:
    """K16's bound from the rows its work needs: every chunk row's flag
    read (1 B); a valid row's op and payload (``row`` B); a delete's
    matched slot (its hash read, its flag read and written); an insert's
    claimed slot written (payload, hash, flag); the pool's validity read
    (1 B a slot) over the ``scanned`` slots that hold the free slots the
    inserts take (``claimed_prefix``)."""
    n_act = n_del + n_ins
    return bound(cap + n_act * (row + 1) + n_del * 10 + n_ins * (row + 9)
                 + scanned, cap + n_act * 40)


def claimed_prefix(torch, before, after, S: int) -> int:
    """The pool slots whose validity K16's inserts need read: up to the
    last slot they claimed (valid after the call, and free before it or
    holding another row hash), or all ``S`` where an insert found no free
    slot.  ``before`` and ``after`` are the pool's (valid, row_hash,
    overflow)."""
    (v0, h0, o0), (v1, h1, o1) = before, after
    if int(o1) > int(o0):
        return S
    new = v1 & (~v0 | (h1 != h0))
    return int(torch.nonzero(new).max()) + 1 if bool(new.any()) else 0


def row_bytes(col, lead: int = 1) -> float:
    """Bytes one row of a column holds (every leaf: data, string lengths,
    null plane); the first ``lead`` dims index the rows."""
    import math

    from risingwave_tpu_torch.common.tree import flatten

    leaves, _ = flatten(col)
    return sum(x.element_size() * x.numel()
               / max(math.prod(x.shape[:lead]), 1) for x in leaves)


def emit_bound(p, w: int, out_cap: int, cols, spec,
               addressing: int) -> tuple[float, str]:
    """The bound of K14's window ``w`` from the bytes its rows need: every
    output plane written (columns, op, valid); each valid row's probe-side
    columns read; and for each row that reads a build row (pairs and
    transitions) the build-side columns plus ``addressing`` bytes (a pool's
    tag and pool_pos, a dense bucket's occupancy)."""
    U, P, S, T = (int(x) for x in (p.U, p.P, p.S, p.total))
    lo, hi = w * out_cap, min((w + 1) * out_cap, T)
    n = max(0, hi - lo)
    n_build = n - max(0, min(hi, U + P + S) - max(lo, U + P))
    probe_b = sum(row_bytes(c) for c, (fp, _, _) in zip(cols, spec.layout)
                  if fp)
    build_b = sum(row_bytes(c) for c, (fp, _, _) in zip(cols, spec.layout)
                  if not fp)
    nbytes = out_cap * (probe_b + build_b + 2) + n * probe_b \
        + n_build * (build_b + addressing)
    return bound(nbytes, n * 10)


def max_abs_err(torch, pairs) -> float:
    """Max |a - b| over pairs of tensors; any difference fails the run
    (every comparison here is exact: the paths are integer, and the
    float64 prices are compared after rounding, bit for bit)."""
    for name, a, b in pairs:
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"{name}: {tuple(a.shape)} {a.dtype} vs "
                 f"{tuple(b.shape)} {b.dtype}")
        if not torch.equal(a, b):
            d = (a.to(torch.float64) - b.to(torch.float64)).abs().max()
            fail(f"{name}: kernel and plain version differ "
                 f"(max abs err {d.item()})")
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rehearse", action="store_true",
                    help="run the phases on the CPU at a small size")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not (ROOT / "risingwave_tpu_torch" / "csrc").is_dir():
        fail("run from a checkout of the repository (package not found)", 2)
    sys.path.insert(0, str(ROOT))
    if args.rehearse:
        device = torch.device("cpu")
        # the rehearsal's shapes are small: more threads only spin
        torch.set_num_threads(2)
    else:
        if not torch.cuda.is_available():
            fail("no CUDA device", 2)
        device = torch.device("cuda")

    from risingwave_tpu_torch import kernels

    # -- 1. build -------------------------------------------------------
    if device.type == "cuda":
        secs = kernels.build_all(verbose=True)
        print(f"[build] kernels built in {secs:.1f} s "
              f"({', '.join(kernels.SOURCES.values())})", flush=True)

    # -- 2. kernel phases -------------------------------------------------
    timer = Timer(torch, device)
    scale = 1 if device.type == "cuda" else 64
    results = {}
    results["hash64"] = phase_hash(torch, device, timer, scale)
    results["probe"] = phase_probe(torch, device, timer, scale)
    results["agg_scatter"] = phase_agg(torch, device, timer, scale)
    results["mv_upsert"] = phase_mv(torch, device, timer, scale)
    results["agg_preagg"] = phase_preagg(torch, device, timer, scale)
    results["mask_indices"] = phase_mask_indices(torch, device, timer, scale)
    results["ring_append"] = phase_ring(torch, device, timer, scale)
    results["nexmark_bids"] = phase_bids(torch, device, timer, scale)
    results["hop_window"] = phase_hop(torch, device, timer, scale)
    results.update(phase_nexmark_events(torch, device, timer, scale))
    results.update(phase_q8_kernels(torch, device, timer, scale))
    results.update(phase_state_kernels(torch, device, timer, scale))
    topn, strings = phase_topn_kernels(torch, device, timer, scale)
    results.update(topn)
    for name, r in strings.items():
        results[name]["strings"] = r
    window, extras = phase_window_kernels(torch, device, timer, scale)
    results.update(window)
    for name, r in extras.items():
        results[name].update(r)
    join, emit_extra = phase_join_kernels(torch, device, timer, scale)
    results.update(join)
    results["join_emit"].update(emit_extra)
    q102, preagg_extra, pool_extra = phase_q102_kernels(torch, device, timer,
                                                        scale)
    results.update(q102)
    results["agg_preagg"].update(preagg_extra)
    results["topn_pool"].update(pool_extra)
    results.update(phase_string_kernels(torch, device, timer, scale))
    results.update(phase_temporal_kernels(torch, device, timer, scale))
    results.update(phase_scalar_kernels(torch, device, timer, scale))
    results.update(phase_slice11_kernels(torch, device, timer, scale))
    sink_kernels = phase_sink_kernels(torch, device, timer, scale)
    results["sink_ring"] = sink_kernels["sink_ring"]
    results.update(phase_shard_kernels(torch, device, timer, scale))
    results.update(phase_k11_lanes(torch, device, timer, scale))
    t0 = time.perf_counter()
    results.update(phase_scale_kernels(torch, device, timer, scale))
    scale_secs = {"kernels": time.perf_counter() - t0}
    if set(results) != set(kernels.KERNELS):
        fail(f"kernel phases {sorted(results)} do not cover "
             f"{sorted(kernels.KERNELS)}")
    # K19b: an executor composed of K1, K3 and the K4 sweep
    results["append_only_dedup"] = sink_kernels["append_only_dedup"]

    # -- 3. card against CPU --------------------------------------------
    for query in ("q7", "q5", "q1"):
        phase_engine_parity(torch, device, query)
    phase_q8_parity(torch, device)
    for query in TOPN_QUERIES:
        phase_topn_parity(torch, device, query)
    for query in WINDOW_QUERIES:
        phase_window_parity(torch, device, query)
    for query in JOIN_QUERIES + ("q102",):
        phase_join_parity(torch, device, query)
    for query in STRING_QUERIES:
        phase_string_parity(torch, device, query)
    for left in (False, True):
        phase_q13_parity(torch, device, left)
    for query in SCALAR_QUERIES:
        phase_sql_parity(torch, device, query, _scalar_ddl(query, "2"),
                         SCALAR_PARITY_CONFIG, SCALAR_MV[query], "2")
    for query in SLICE11_QUERIES:
        rate = SLICE11_PARITY_RATE[query]
        phase_sql_parity(torch, device, query, _slice11_ddl(query, rate),
                         SLICE11_PARITY_CONFIG, "bench_mv", rate)

    # -- 4-5. main paths --------------------------------------------------
    rates = {}
    eowc_info = {}
    for r in results.values():
        r["launches"] = 0
        r["launches_by_query"] = {}
    for query in QUERIES:
        if query == "q8":
            launches, rates[query] = phase_q8_main_path(torch, device, scale)
        elif query in TOPN_QUERIES:
            launches, rates[query] = phase_topn_main_path(torch, device,
                                                          scale, query)
        elif query in WINDOW_QUERIES:
            launches, rates[query], info = phase_window_main_path(
                torch, device, scale, query)
            if "probe" in info:
                results["probe"]["at_ow_bid"] = info.pop("probe")
            results["over_window"].setdefault("at_pool", {})[query] = info
        elif query in JOIN_QUERIES:
            launches, rates[query] = phase_join_main_path(torch, device,
                                                          scale, query)
        elif query == "q102":
            launches, rates[query] = phase_q102_main_path(torch, device,
                                                          scale)
        elif query in STRING_QUERIES:
            launches, rates[query] = phase_string_main_path(torch, device,
                                                            scale, query)
        elif query in ("q13", "q13 churn"):
            launches, rates[query] = phase_q13_main_path(
                torch, device, scale, churn_path=query == "q13 churn")
        elif query in SCALAR_QUERIES:
            launches, rates[query], _ = phase_sql_main_path(
                torch, device, query, _scalar_ddl(query, "1000000"),
                _scalar_config(scale), K23_REST_KERNELS,
                SCALAR_CHECKS[query])
        elif query in SLICE11_QUERIES:
            launches, rates[query], info = phase_sql_main_path(
                torch, device, query,
                _slice11_ddl(query, SLICE11_RATE[query]),
                _slice11_config(scale), SLICE11_KERNELS,
                SLICE11_CHECKS[query],
                "person" if query == "person_states" else "bid")
            eowc_info.update(info)
            if device.type == "cuda" and info.get("windows", 20) < 20:
                fail(f"{query} closed {info['windows']} windows, fewer "
                     "than 20")
        else:
            launches, rates[query] = phase_main_path(torch, device, scale,
                                                     query)
        for name, n in launches.items():
            if name in results:
                results[name]["launches"] += n
                results[name]["launches_by_query"][query] = n
        missing = [k for k in PATH_KERNELS[query] if launches[k] <= 0]
        if device.type == "cuda" and missing:
            fail(f"{query}: kernels {missing} were not launched on the "
                 "main path")
    tag = "q6_bid clean"
    launches, rates[tag] = phase_window_clean_path(torch, device, scale)
    for name, n in launches.items():
        if name in results:
            results[name]["launches"] += n
            results[name]["launches_by_query"][tag] = n
    missing = [k for k in PATH_KERNELS[tag] if launches[k] <= 0]
    if device.type == "cuda" and missing:
        fail(f"{tag}: kernels {missing} were not launched on the path")

    # -- 6. the durable main paths and their cold starts ------------------
    durable = {}
    for query in ("q7", "q8", "q19", "q13"):
        if query == "q13":
            launches, rate, info = phase_q13_durable(torch, device, scale,
                                                     rates["q13 churn"])
        else:
            launches, rate, info = phase_durable(torch, device, scale, query,
                                                 rates[query])
        durable[query] = (rate, info)
        tag = f"{query} durable"
        for name, n in launches.items():
            if name in results:
                results[name]["launches"] += n
                results[name]["launches_by_query"][tag] = n
        missing = [k for k in DURABLE_KERNELS[query] if launches[k] <= 0]
        if device.type == "cuda" and missing:
            fail(f"{tag}: kernels {missing} were not launched on the "
                 "main path")

    # -- 7. sinks, cascades, SHOW/DROP and the dedup ----------------------
    sink_runs = run_sink_paths(torch, device, scale, results)

    # -- 8. vnode-sharded q5 and q7 over 4 lanes --------------------------
    shard_runs = run_sharded_paths(torch, device, scale, results)

    # -- 9. the vnode-sharded join DAG: q8 over 4 lanes ------------------
    shard_runs.update(run_q8_sharded_paths(torch, device, scale, results))

    # -- 10. the vnode scale plane: partitions 2 -> 4 -> 2 -----------------
    scale_runs = run_scale_paths(torch, device, scale, results, scale_secs)

    line = {"kernels": [dict(name=name, **r) for name, r in results.items()]}
    print(json.dumps(line))
    if device.type != "cuda":
        print("chip_smoke: CPU rehearsal passed (no device result)")
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    for query in QUERIES + ("q6_bid clean",):
        print(f"[main] {query} rows/s {rates[query]:.0f}")
    for query, (rate, info) in durable.items():
        print(f"[main] {query} durable rows/s {rate:.0f}, cold start "
              f"{info['recover_s']:.3f} s")
    print(f"[main] q7_eowc closed {eowc_info['windows']} windows, "
          f"{eowc_info['rows']} rows emitted")
    for path, (rate, info) in sink_runs.items():
        extra = ""
        if "T" in info:
            extra = (f", T = {info['T']} keeps {100 * info['share']:.2f}% of "
                     f"q5's {info['q5_rows']} rows, backfills "
                     f"{[round(x, 3) for x in info['backfill_ms']]} ms")
        if "recover_s" in info:
            extra += f", cold start {info['recover_s']:.3f} s"
        print(f"[main] {path} rows/s {rate:.0f}{extra}")
    for path, (rate, info) in shard_runs.items():
        extra = f", cold start {info['recover_s']:.3f} s" \
            if "recover_s" in info else ""
        print(f"[main] {path} rows/s {rate:.0f} on {SHARD_LANES} lanes"
              f"{extra}")
    for path, (rate, info) in scale_runs.items():
        if path == "troublemaker":
            continue
        print(f"[main] {path} rows/s {rate:.0f} over {info['rows']} rows; "
              f"handover ms (clear, load, slice, transplant, reseal) "
              f"{info['handover_ms']}; moved entries {info['entries']}; npz "
              f"members the loads read {info['chain_members']}")
    print(f"[time] the scale plane's phases took "
          f"{sum(scale_secs.values()):.1f} s of the run's "
          f"{time.perf_counter() - t_start:.1f} s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in scale_secs.items()))
    print(smi.stdout.strip())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kernel_entry(source: str, replaces: str, ms: float, plain_ms: float,
                 b: tuple[float, str], library_ms, err: float) -> dict:
    return {"route": "cuda", "source": f"risingwave_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
            "bound_by": b[1], "library_ms": library_ms}


# ---------------------------------------------------------------------------
# 2. kernel phases


def phase_hash(torch, device, timer, scale):
    from risingwave_tpu_torch.common.chunk import NCol
    from risingwave_tpu_torch.common.hash import (
        hash64_columns, hash64_columns_plain)

    g = torch.Generator(device="cpu").manual_seed(1)
    cap = 8192 // scale
    keys = torch.randint(-2**62, 2**62, (cap,), generator=g)
    keys[: cap // 2] = keys[: cap // 2] % 7          # heavy duplicates
    keys[0] = 0
    cols = [keys.to(device)]
    i32 = torch.randint(-2**31, 2**31 - 1, (cap,), generator=g,
                        dtype=torch.int32)
    nulls = torch.rand(cap, generator=g) < 0.3
    ncols = [cols[0], NCol(i32.to(device), nulls.to(device)),
             (keys % 2 == 0).to(device)]
    pairs = []
    for name, c in (("int64 key", cols), ("int64+nullable int32+bool", ncols)):
        pairs.append((f"hash64 {name}", hash64_columns(c),
                      hash64_columns_plain(c)))
    err = max_abs_err(torch, pairs)
    ms = timer(lambda i: hash64_columns(cols), 200)
    plain_ms = timer(lambda i: hash64_columns_plain(cols), 50)
    # per row: 8 B key read, 8 B hash written; ~20 integer ops
    b = bound(cap * 16, cap * 20)
    print(f"[hash64] exact; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {b[0]:.5f} ms", flush=True)
    return kernel_entry("hash64.cu", "risingwave_tpu/common/hash.py:183",
                        ms, plain_ms, b, None, err)


def _prefilled_table(torch, device, size, fill, g):
    """A table half full of random keys, a fifth of them tombstoned."""
    from risingwave_tpu_torch.state.hash_table import HashTable

    t = HashTable.create([torch.zeros(1, dtype=torch.int64)], size, "cpu")
    keys = torch.randint(-2**62, 2**62, (fill,), generator=g)
    t.lookup_or_insert([keys], torch.ones(fill, dtype=torch.bool))
    t.clear_where(torch.rand(size, generator=g) < 0.2)
    out = t.clone()
    return type(t)(tuple(c.to(device) for c in out.key_cols),
                   out.occupied.to(device), out.tombstone.to(device),
                   size), keys


def _probe_chunk(torch, table_keys, cap, g):
    """8192 keys: a third present in the table, a third new and distinct,
    a third heavy duplicates of a few new keys."""
    k = cap // 3
    present = table_keys[torch.randint(0, table_keys.shape[0], (k,),
                                       generator=g)]
    fresh = torch.randint(-2**62, 2**62, (k,), generator=g)
    dups = torch.randint(-2**62, 2**62, (8,), generator=g)[
        torch.randint(0, 8, (cap - 2 * k,), generator=g)]
    keys = torch.cat([present, fresh, dups])
    return keys[torch.randperm(cap, generator=g)]


def _keys_at(size: int, homes) -> "np.ndarray":
    """One int64 key for each wanted home slot of a ``size``-slot table
    (distinct keys, the smallest positive ones)."""
    import numpy as np
    import torch

    from risingwave_tpu_torch.common.hash import hash64_columns_plain

    cand = np.arange(1, 1 + 64 * size, dtype=np.int64)
    hs = (hash64_columns_plain([torch.from_numpy(cand)])
          & (size - 1)).numpy()
    out: list[int] = []
    for want in homes:
        out.append(int(cand[(hs == want) & ~np.isin(cand, out)][0]))
    return np.array(out, np.int64)


def k3_cases() -> list:
    """K3's claim-round corner cases as scripts of numpy arrays, shared
    with ``tests/test_torch_probe_rounds.py``: ``(name, size, key kind,
    steps)``; a step is ``("insert" | "lookup", cols, valid)`` or
    ``("clear", pred)``, ``cols`` a list of key columns (``"int64"``: an
    int64 key; ``"int64+varchar8"``: it and a VARCHAR(8) as ``(data,
    lens)``; ``"float64"``)."""
    import numpy as np

    ones = lambda n: np.ones(n, bool)  # noqa: E731
    cases = []
    # three rows of one new key and two of another in one chunk
    rng = np.random.default_rng(31)
    k = rng.integers(0, 10**9, 64)
    k[[5, 17, 40]] = 10**12 + 1
    k[[2, 3]] = 10**12 + 2
    cases.append(("duplicate new keys", 1 << 8, "int64", [
        ("insert", [rng.integers(0, 10**9, 96)], ones(96)),
        ("insert", [k], ones(64)), ("lookup", [k], ones(64))]))
    # two new keys homed 4 * cap apart share a scratch entry
    size, a = 1 << 12, 1000
    ka, kb = _keys_at(size, [a, a + 4 * 64])
    k = np.arange(10**6, 10**6 + 64, dtype=np.int64)
    k[9], k[3] = ka, kb
    valid = np.zeros(64, bool)
    valid[[3, 9]] = True
    cases.append(("scratch collision", size, "int64",
                  [("insert", [k], valid)]))
    # an entry round later than the round another key claimed that slot
    a = 2000
    p1, p2, ka, kb = _keys_at(size, [a, a + 1, a, a + 2])
    k = np.arange(10**6, 10**6 + 64, dtype=np.int64)
    k[0], k[50] = ka, kb
    valid = np.zeros(64, bool)
    valid[[0, 50]] = True
    cases.append(("late entry", size, "int64", [
        ("insert", [np.array([p1, p2])], ones(2)),
        ("insert", [k], valid), ("lookup", [k], valid)]))
    # a run of eight keys of one home, every other one tombstoned
    size, a = 1 << 10, 300
    same = _keys_at(size, [a] * 14)
    pred = np.zeros(size, bool)
    pred[[a, a + 2, a + 4, a + 6]] = True
    k = np.arange(10**6, 10**6 + 64, dtype=np.int64)
    k[:6] = same[[1, 3, 7, 8, 9, 0]]
    valid = np.zeros(64, bool)
    valid[:6] = True
    cases.append(("tombstones", size, "int64", [
        ("insert", [same[:8]], ones(8)), ("clear", pred),
        ("lookup", [k], valid), ("insert", [k], valid)]))
    # a near-full table: inserts and then lookups reach the round bound
    rng = np.random.default_rng(33)
    steps = [("insert", [rng.integers(0, 10**12, 80)], ones(80))
             for _ in range(3)]
    steps.append(("insert", [rng.integers(0, 10**12, 64)],
                  rng.random(64) < 0.9))
    steps.append(("clear", rng.random(1 << 8) < 0.25))
    steps.append(("lookup", [rng.integers(10**13, 10**14, 64)], ones(64)))
    cases.append(("near full", 1 << 8, "int64", steps))
    # an all-invalid chunk
    rng = np.random.default_rng(34)
    k = rng.integers(0, 100, 64)
    cases.append(("all invalid", 1 << 8, "int64", [
        ("insert", [rng.integers(0, 100, 40)], ones(40)),
        ("insert", [k], np.zeros(64, bool)),
        ("lookup", [k], np.zeros(64, bool))]))
    # string keys with padding past their lengths, duplicate-heavy
    rng = np.random.default_rng(35)
    steps = []
    for _ in range(3):
        cols = [rng.integers(0, 6, 128).astype(np.int64),
                (rng.integers(0, 3, (128, 8)).astype(np.uint8),
                 rng.integers(0, 3, 128).astype(np.int32))]
        valid = rng.random(128) < 0.9
        steps += [("insert", cols, valid), ("lookup", cols, valid)]
    cases.append(("strings", 1 << 9, "int64+varchar8", steps))
    # float64 keys: -0.0, NaN, infinities, a subnormal
    tiny = float(np.finfo(np.float64).tiny)
    special = np.array([0.0, -0.0, tiny / 4, np.nan, np.inf, -np.inf, 1.5,
                        2.5], np.float64)
    steps = []
    for _ in range(3):
        k = rng.choice(special, 128)
        k[::3] = rng.integers(-40, 40, len(k[::3])) / 4.0
        valid = rng.random(128) < 0.9
        steps += [("insert", [k], valid), ("lookup", [k], valid)]
    cases.append(("floats", 1 << 9, "float64", steps))
    # 512 rows into a half-full 2^12 table, a fifth tombstoned: a third
    # present, a third new, a third copies of 8 new keys
    rng = np.random.default_rng(36)
    size, cap = 1 << 12, 512
    base = rng.integers(-2**62, 2**62, size // 2)
    t3 = cap // 3
    k = np.concatenate([rng.choice(base, t3), rng.integers(-2**62, 2**62, t3),
                        rng.integers(-2**62, 2**62, 8)[rng.integers(
                            0, 8, cap - 2 * t3)]])[rng.permutation(cap)]
    valid = rng.random(cap) < 0.95
    cases.append(("heavy duplicates", size, "int64", [
        ("insert", [base], ones(size // 2)),
        ("clear", rng.random(size) < 0.2), ("lookup", [k], valid),
        ("insert", [k], valid), ("lookup", [k], valid)]))
    return cases


def k3_torch_cols(torch, cols, device):
    """A ``k3_cases`` step's key columns as the port's key columns."""
    from risingwave_tpu_torch.common.chunk import StrCol

    return [StrCol(torch.from_numpy(c[0]).to(device),
                   torch.from_numpy(c[1]).to(device))
            if isinstance(c, tuple) else torch.from_numpy(c).to(device)
            for c in cols]


def k3_empty_table(torch, size: int, kind: str, device):
    from risingwave_tpu_torch.common.chunk import StrCol
    from risingwave_tpu_torch.state.hash_table import HashTable

    protos = [torch.zeros(1, dtype=torch.float64 if kind == "float64"
                          else torch.int64)]
    if kind == "int64+varchar8":
        protos.append(StrCol(torch.zeros((1, 8), dtype=torch.uint8),
                             torch.zeros(1, dtype=torch.int32)))
    return HashTable.create(protos, size, device)


def _probe_planes(torch, tag, res, t):
    """The probe's outputs and the table's tensors, named; float key
    stores by bit pattern (a NaN key is not equal to itself)."""
    from risingwave_tpu_torch.common.hash import key_leaves

    out = [(f"{tag} slots", res[1]), (f"{tag} inserted/found", res[2]),
           (f"{tag} overflow", res[3]), (f"{tag} n_over", res[4]),
           (f"{tag} occupied", t.occupied), (f"{tag} tombstone", t.tombstone)]
    for i, (d, n, _) in enumerate(key_leaves(t.key_cols)):
        if d.dtype.is_floating_point:
            d = d.view(torch.int64 if d.element_size() == 8 else torch.int32)
        out.append((f"{tag} key store {i}", d))
        if n is not None:
            out.append((f"{tag} key nulls {i}", n))
    return out


#: claimant lists up to this long run their claim rounds on block 0 alone
#: (``ONE_BLOCK_MAX`` in ``csrc/probe.cu``)
PROBE_ONE_BLOCK_MAX = 1024


def _probe_paths(device) -> tuple:
    """The claim rounds' branches a check runs: on the card the
    cooperative grid forced for every round, and the default (the grid
    while more than ``PROBE_ONE_BLOCK_MAX`` rows are listed, then block 0
    alone; a short list is block 0's from the start); the CPU runs the
    plain version whatever the branch."""
    return ("grid", "default") if device.type == "cuda" else ("default",)


def _probe_on(t, path: str, cols, valid, insert: bool, hashes=None):
    """``t``'s probe on the claim rounds' ``path`` branch."""
    if path == "grid":
        return t._probe_cuda(cols, valid, insert, hashes, grid_only=True)
    return t._probe(cols, valid, insert, hashes)


def _check_probe_path(torch, device, ht, path, insert):
    """On the card, the claim kernel of the last insert took ``path``'s
    branches: returns ``(claimants, grid rounds, one-block rounds)``."""
    if device.type != "cuda" or not insert:
        return None
    n, grid_rounds, block_rounds = ht.probe_claim_stats(device)
    if n and path == "grid" and (grid_rounds == 0 or block_rounds):
        fail(f"probe: forced grid branch ran {grid_rounds} grid and "
             f"{block_rounds} one-block rounds")
    if path == "default" and 0 < n <= PROBE_ONE_BLOCK_MAX and (
            grid_rounds or block_rounds == 0):
        fail(f"probe: {n} claimants ran {grid_rounds} grid and "
             f"{block_rounds} one-block rounds, not block 0 alone")
    return n, grid_rounds, block_rounds


def probe_bound(cap: int, n_valid: int, n_ins: int,
                kw: float) -> tuple[float, str]:
    """K3's bound from what the chunk's data needs: every row's valid flag
    read and its slot and flags written (7 B); a valid row's home slot
    (4 B) and key (``kw`` B) read and one probe read of the table
    (occupied, tombstone, key); a key and its occupied flag written a
    claim."""
    return bound(cap * 7 + n_valid * (2 * kw + 6) + n_ins * (kw + 1),
                 n_valid * 30)


def phase_probe_cases(torch, device) -> str:
    """Every ``k3_cases`` script on the card, kernel against plain
    version at each step, on the forced grid branch and the default one
    (the cases' short lists: block 0 alone)."""
    from risingwave_tpu_torch.state import hash_table as ht

    n_steps = 0
    took = {"grid": 0, "one block": 0}
    for path in _probe_paths(device):
        for name, size, kind, steps in k3_cases():
            tk = k3_empty_table(torch, size, kind, device)
            tp = k3_empty_table(torch, size, kind, device)
            for i, step in enumerate(steps):
                if step[0] == "clear":
                    pred = torch.from_numpy(step[1]).to(device)
                    tk.clear_where_plain(pred)
                    tp.clear_where_plain(pred)
                    continue
                insert = step[0] == "insert"
                cols = k3_torch_cols(torch, step[1], device)
                valid = torch.from_numpy(step[2]).to(device)
                rk = _probe_on(tk, path, cols, valid, insert)
                rp = tp._probe_plain(cols, valid, insert)
                st = _check_probe_path(torch, device, ht, path, insert)
                if st is not None and st[0]:
                    took["grid" if st[1] else "one block"] += 1
                tag = f"probe case {name!r} step {i} ({path})"
                max_abs_err(torch, [
                    (x[0], x[1], y[1]) for x, y in
                    zip(_probe_planes(torch, tag, rk, tk),
                        _probe_planes(torch, tag, rp, tp))])
                n_steps += 1
    return (f"{len(k3_cases())} cases, {n_steps} probe steps, claims on "
            f"the grid branch {took['grid']} times and on the one-block "
            f"branch {took['one block']}")


#: K3's two CUDA functions, for the profiler's device time of each
PROBE_KERNELS = ("probe_walk", "probe_claim")
#: K13's: the rank, then the update's three passes
JOIN_UPDATE_KERNELS = ("join_rank_kernel", "join_count", "join_place",
                       "join_degree")


def phase_probe(torch, device, timer, scale):
    from risingwave_tpu_torch.common.hash import hash64_columns
    from risingwave_tpu_torch.state import hash_table as ht

    g = torch.Generator(device="cpu").manual_seed(2)
    size, cap = (1 << 18) // scale, 8192 // scale
    base, tkeys = _prefilled_table(torch, device, size, size // 2, g)
    keys = _probe_chunk(torch, tkeys, cap, g).to(device)
    valid = (torch.rand(cap, generator=g) < 0.95).to(device)
    pairs = []
    stats = {}
    paths = _probe_paths(device)
    for path in paths:
        for insert in (True, False):
            tk, tp = base.clone(), base.clone()
            rk = _probe_on(tk, path, [keys], valid, insert)
            rp = tp._probe_plain([keys], valid, insert)
            if insert:
                n_inserted = int(rp[2].sum())
                stats[path] = _check_probe_path(torch, device, ht, path,
                                                True)
            tag = f"probe {'insert' if insert else 'lookup'} ({path})"
            pairs += [(x[0], x[1], y[1]) for x, y in
                      zip(_probe_planes(torch, tag, rk, tk),
                          _probe_planes(torch, tag, rp, tp))]
    err = max_abs_err(torch, pairs)
    cases = phase_probe_cases(torch, device)
    # K3 alone: the hashes (K1) are computed before the timed calls
    h = hash64_columns([keys])
    n_it = 20
    clones = [base.clone() for _ in range(n_it + 1)]
    ms = timer(lambda i: clones[i]._probe([keys], valid, True, h), n_it)
    # ~1 ms of host time a call: a 2 ms pre-fill keeps the queue ahead
    lookup_ms = timer(lambda i: base._probe([keys], valid, False, h), 100,
                      2.0)
    grid_ms = ms
    split = None
    if device.type == "cuda":
        fc = [base.clone() for _ in range(n_it + 1)]
        grid_ms = timer(lambda i: fc[i]._probe_cuda(
            [keys], valid, True, h, grid_only=True), n_it)
        pc = [base.clone() for _ in range(n_it + 1)]
        split = device_ms_by_kernel(
            torch, device, lambda i: pc[i]._probe([keys], valid, True, h),
            n_it, PROBE_KERNELS)
    pclones = [base.clone() for _ in range(4)]
    plain_ms = timer(lambda i: pclones[i]._probe_plain([keys], valid, True),
                     3)
    n_valid = int(valid.sum())
    b = probe_bound(cap, n_valid, n_inserted, 8)
    lb = probe_bound(cap, n_valid, 0, 8)
    st = stats.get("default")
    rounds = "" if st is None else (
        f"; {st[0]} claimants, {st[1]} grid and {st[2]} one-block rounds")
    by_kernel = "" if split is None else (
        f" (device time walk {split['probe_walk']:.4f} + rounds "
        f"{split['probe_claim']:.4f} ms)")
    print(f"[probe] exact (slot layout, insert and lookup, on the "
          f"{', '.join(paths)} branches{rounds}; {cases}); K1's hashes "
          f"apart: insert {ms:.4f} ms{by_kernel}, the grid branch forced "
          f"{grid_ms:.4f}, lookup {lookup_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b[0]:.5f} ms (lookup {lb[0]:.5f})",
          flush=True)
    out = kernel_entry("probe.cu", "risingwave_tpu/state/hash_table.py:236",
                       ms, plain_ms, b, None, err)
    out.update(lookup_ms=lookup_ms, lookup_bound_ms=lb[0],
               grid_branch_ms=grid_ms)
    if split is not None:
        out.update(walk_ms=split["probe_walk"],
                   claim_ms=split["probe_claim"])
    if st is not None:
        out.update(claimants=st[0], grid_rounds=st[1], block_rounds=st[2])
    return out


def phase_agg(torch, device, timer, scale):
    from risingwave_tpu_torch.stream.hash_agg import (
        agg_scatter, agg_scatter_plain)

    g = torch.Generator(device="cpu").manual_seed(3)
    size, cap = (1 << 18) // scale, 8192 // scale
    # q7 shape: nearly all rows hit one or two window slots
    slots = torch.where(torch.rand(cap, generator=g) < 0.9,
                        torch.tensor(12345 % size), torch.tensor(777 % size))
    slots = slots.to(torch.int32)
    slots[torch.rand(cap, generator=g) < 0.02] = size   # dropped rows
    inserted = torch.zeros(cap, dtype=torch.bool)
    inserted[0] = True
    prices = torch.randint(100, 10**8, (cap,), generator=g)
    signs = torch.ones(cap, dtype=torch.int64)
    init_max = -(1 << 63)

    def fresh():
        st = [torch.randint(0, 10**6, (size,), generator=g),
              torch.randint(0, 10**6, (size,), generator=g)]
        return st, torch.randint(0, 10**6, (size,), generator=g), \
            torch.zeros(size, dtype=torch.bool)

    prims0, rc0, dirty0 = fresh()
    to = lambda t: t.to(device)  # noqa: E731
    slots, inserted, prices, signs = map(to, (slots, inserted, prices,
                                              signs))
    modes, inits, values = ["max", "add"], [init_max, 0], [prices, signs]

    def run(fn, prims, rc, dirty):
        fn(prims, modes, inits, values, slots, inserted, signs, rc, dirty)

    a = ([to(p.clone()) for p in prims0], to(rc0.clone()), to(dirty0.clone()))
    b = ([to(p.clone()) for p in prims0], to(rc0.clone()), to(dirty0.clone()))
    run(agg_scatter, *a)
    run(agg_scatter_plain, *b)
    err = max_abs_err(torch, [("agg max", a[0][0], b[0][0]),
                       ("agg count", a[0][1], b[0][1]),
                       ("agg row_count", a[1], b[1]),
                       ("agg dirty", a[2], b[2])])
    ms = timer(lambda i: run(agg_scatter, *a), 200)
    plain_ms = timer(lambda i: run(agg_scatter_plain, *b), 20)
    live = slots < size
    idx = slots[live].to(torch.int64)
    pv, sv = prices[live], signs[live]

    def library(i):
        a[0][0].scatter_reduce_(0, idx, pv, reduce="amax")
        a[0][1].index_add_(0, idx, sv)
        a[1].index_add_(0, idx, sv)

    library_ms = timer(library, 200)
    # per row: slot 4 B, inserted 1 B, sign 8 B, 2 contributions 16 B
    b_ = bound(cap * 29 + 2 * 3 * 16, cap * 4)
    print(f"[agg_scatter] exact; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, library {library_ms:.4f} ms, bound {b_[0]:.5f} ms",
          flush=True)
    return kernel_entry("agg_scatter.cu",
                        "risingwave_tpu/stream/hash_agg.py:368",
                        ms, plain_ms, b_, library_ms, err)


def phase_mv(torch, device, timer, scale):
    from risingwave_tpu_torch.common.chunk import (
        OP_DELETE, OP_INSERT, OP_UPDATE_DELETE, OP_UPDATE_INSERT, Chunk)
    from risingwave_tpu_torch.common.types import DataType, Field, Schema
    from risingwave_tpu_torch.stream.materialize import (
        MaterializeExecutor, mv_upsert, mv_upsert_plain)

    g = torch.Generator(device="cpu").manual_seed(4)
    size, half = (1 << 18) // scale, 4096 // scale
    schema = Schema((Field("window_start", DataType.TIMESTAMP),
                     Field("max_price", DataType.INT64),
                     Field("bids", DataType.INT64)))
    scratch = MaterializeExecutor(schema, [0], size)._scratch_for(device)
    base, tkeys = _prefilled_table(torch, device, size, size // 2, g)
    values0 = tuple(torch.randint(0, 10**9, (size,), generator=g)
                    for _ in range(3))
    # flush-shaped chunk: U-/U+ pairs of present keys, -/+ of new keys,
    # and [+pk,-pk] / [-pk,+pk] pairs on one key each
    keys = _probe_chunk(torch, tkeys, half, g)
    keys[-4:] = torch.tensor([11, 11, 22, 22])
    pair_ops = torch.where(torch.rand(half, generator=g) < 0.7,
                           torch.tensor([OP_UPDATE_DELETE]),
                           torch.tensor([OP_DELETE]))
    ops = torch.stack([pair_ops, torch.where(
        pair_ops == OP_UPDATE_DELETE, torch.tensor([OP_UPDATE_INSERT]),
        torch.tensor([OP_INSERT]))], 1).reshape(-1).to(torch.int8)
    col_k = keys.repeat_interleave(2)
    ops[-8:] = torch.tensor([OP_INSERT, OP_DELETE] * 2 + [OP_DELETE,
                            OP_INSERT] * 2, dtype=torch.int8)
    col_k[-8:] = torch.tensor([33, 33, 44, 44, 55, 55, 66, 66])
    valid = torch.rand(2 * half, generator=g) < 0.9
    cols = (col_k, torch.randint(0, 10**9, (2 * half,), generator=g),
            torch.randint(0, 10**9, (2 * half,), generator=g))
    chunk = Chunk(tuple(c.to(device) for c in cols), ops.to(device),
                  valid.to(device), schema)

    def fresh():
        t = base.clone()
        return t, tuple(v.clone().to(device) for v in values0)

    probe_t = base.clone()
    _, slots, _, _ = probe_t.lookup_or_insert([chunk.columns[0]], chunk.valid)

    def prepared():
        t, vals = fresh()
        t.occupied.copy_(probe_t.occupied)
        t.key_cols[0].copy_(probe_t.key_cols[0])
        return t, vals

    tk, vk = prepared()
    tp, vp = prepared()
    mv_upsert(tk, vk, chunk, slots, scratch)
    mv_upsert_plain(tp, vp, chunk, slots)
    pairs = [("mv occupied", tk.occupied, tp.occupied),
             ("mv tombstone", tk.tombstone, tp.tombstone)]
    pairs += [(f"mv value {i}", a, b) for i, (a, b) in enumerate(zip(vk, vp))]
    err = max_abs_err(torch, pairs)
    n_it = 20
    states = [prepared() for _ in range(n_it + 1)]
    ms = timer(lambda i: mv_upsert(*states[i], chunk, slots, scratch), n_it)
    pstates = [prepared() for _ in range(4)]
    plain_ms = timer(lambda i: mv_upsert_plain(*pstates[i], chunk, slots), 3)
    last = torch.full((size + 1,), -1, dtype=torch.int32, device=device)
    row_idx = torch.arange(2 * half, dtype=torch.int32, device=device)
    tgt = slots.to(torch.int64)
    # no one PyTorch call resolves the last op per slot and writes the
    # winners: the amax scatter of the row index is only the first pass
    first_pass_ms = timer(lambda i: last.scatter_reduce_(
        0, tgt, row_idx, reduce="amax"), 200)
    n_rows = 2 * half
    # per row: slot 4 B, op 1 B, valid 1 B, 24 B of values; per winning
    # slot 24 B of values + 2 B of flags written
    b = bound(n_rows * 30 + half * 26, n_rows * 8)
    print(f"[mv_upsert] exact; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library none (scatter_reduce_ amax of the row index, its first "
          f"pass, {first_pass_ms:.4f} ms), bound {b[0]:.5f} ms", flush=True)
    out = kernel_entry("mv_upsert.cu",
                       "risingwave_tpu/stream/materialize.py:108",
                       ms, plain_ms, b, None, err)
    out["first_pass_ms"] = first_pass_ms
    return out


def k5_cases() -> list:
    """K5's corner cases, shared with
    ``tests/test_torch_ranked_preagg_rounds.py``: dicts of numpy arrays in
    chunk order, ``keys`` a list of key columns (an int64 array; ``("str",
    bytes [n, w] uint8, lens int32)``; ``("null", payload, null mask)``),
    ``hash`` the key hashes to sort by (None: the keys' own), ``valid``,
    ``signs`` (int32) and ``prims`` as ``(mode, init, values)`` (int64,
    int32 or float64 lifted contributions)."""
    import numpy as np

    i64min, i64max = -2**63, 2**63 - 1
    i32min, i32max = -2**31, 2**31 - 1
    cases = []

    def count_sum(rng, n, valid):
        signs = np.where(valid, np.where(rng.random(n) < 0.3, -1, 1),
                         0).astype(np.int32)
        s64 = signs.astype(np.int64)
        return signs, [("add", 0, s64),
                       ("add", 0, s64 * rng.integers(-10**15, 10**15, n))]

    # one segment over every tile: 4133 rows on one key (8+ tiles of 512)
    rng = np.random.default_rng(51)
    n = 4133
    valid = np.ones(n, bool)
    valid[-7:] = False
    signs, prims = count_sum(rng, n, valid)
    cases.append(dict(name="one segment over every tile",
                      keys=[np.full(n, 7, np.int64)], hash=None,
                      valid=valid, signs=signs, prims=prims))
    # segment edges on tile edges: runs of 512, 1024 and 512 rows
    rng = np.random.default_rng(52)
    k = np.repeat(np.array([11, 12, 13, 14], np.int64), [512, 1024, 512, 512])
    n = len(k)
    k = k[rng.permutation(n)]
    valid = np.ones(n, bool)
    signs, prims = count_sum(rng, n, valid)
    cases.append(dict(name="segment edges on tile edges", keys=[k],
                      hash=None, valid=valid, signs=signs, prims=prims))
    # n not a multiple of the tile, a few hundred runs of every length
    rng = np.random.default_rng(53)
    n = 3001
    valid = rng.random(n) < 0.9
    signs, prims = count_sum(rng, n, valid)
    cases.append(dict(name="ragged n", keys=[rng.integers(0, 400, n)],
                      hash=None, valid=valid, signs=signs, prims=prims))
    # an all-invalid chunk
    rng = np.random.default_rng(54)
    n = 1100
    valid = np.zeros(n, bool)
    signs, prims = count_sum(rng, n, valid)
    cases.append(dict(name="all invalid", keys=[rng.integers(0, 5, n)],
                      hash=None, valid=valid, signs=signs, prims=prims))
    # NULL keys: one NULL group whatever the payload under the null
    rng = np.random.default_rng(55)
    n = 1500
    valid = rng.random(n) < 0.95
    null = rng.random(n) < 0.3
    signs, prims = count_sum(rng, n, valid)
    cases.append(dict(name="NULL keys",
                      keys=[("null", rng.integers(0, 6, n), null),
                            rng.integers(0, 3, n)],
                      hash=None, valid=valid, signs=signs, prims=prims))
    # string keys under one forced hash: runs split by bytes and lengths
    # alone, the padding past the length included
    rng = np.random.default_rng(56)
    n = 1300
    data = rng.integers(0, 3, (n, 8)).astype(np.uint8)
    data[:, 3:] = 0
    lens = rng.integers(1, 4, n).astype(np.int32)
    data[rng.random(n) < 0.1, 7] = 9  # padding that differs
    valid = rng.random(n) < 0.9
    signs, prims = count_sum(rng, n, valid)
    cases.append(dict(name="string keys, one hash",
                      keys=[("str", data, lens)],
                      hash=np.full(n, 0x5DEECE66D, np.int64), valid=valid,
                      signs=signs, prims=prims))
    # min and max of int64 and int32 with their inits, a float64 sum and
    # max, over retractions (a retracted row lifts to the init)
    rng = np.random.default_rng(57)
    n = 2600
    valid = rng.random(n) < 0.9
    signs = np.where(valid, np.where(rng.random(n) < 0.3, -1, 1),
                     0).astype(np.int32)
    ins = signs > 0
    v64 = rng.integers(-10**18, 10**18, n)
    v32 = rng.integers(i32min, i32max, n).astype(np.int32)
    f64 = rng.normal(0, 1e6, n)
    prims = [("add", 0, signs.astype(np.int64)),
             ("max", i64min, np.where(ins, v64, i64min)),
             ("min", i64max, np.where(ins, v64, i64max)),
             ("max", i32min, np.where(ins, v32, i32min).astype(np.int32)),
             ("min", i32max, np.where(ins, v32, i32max).astype(np.int32)),
             ("add", 0, np.where(ins, v32, 0).astype(np.int32)),
             ("add", 0.0, np.where(ins, f64, 0.0)),
             ("max", float("-inf"), np.where(ins, f64, float("-inf")))]
    k = np.where(rng.random(n) < 0.5, 3, rng.integers(0, 50, n))
    cases.append(dict(name="min and max with inits", keys=[k], hash=None,
                      valid=valid, signs=signs, prims=prims))
    # a sharded lane's received rows, cut down: 10,240 rows, 27 valid, on
    # (auction, window_start), count(*)
    cases.append(k5_lane_case(10_240, 27, seed=58))
    return cases


def k5_lane_case(n: int, n_valid: int, seed: int) -> dict:
    """q5 sharded's keyed half on one lane: ``n`` received rows (the lanes
    x chunk exchange buffer), ``n_valid`` of them valid partial rows on
    (auction, window_start), count(*) as the sum of the partial counts."""
    import numpy as np

    rng = np.random.default_rng(seed)
    valid = np.zeros(n, bool)
    valid[rng.choice(n, n_valid, replace=False)] = True
    auction = np.where(valid, rng.integers(1000, 1040, n), 0)
    ws = np.where(valid, rng.integers(0, 3, n) * HOP_SLIDE_US
                  + 1_436_918_400_000_000, 0)
    signs = valid.astype(np.int32)
    counts = np.where(valid, rng.integers(1, 40, n), 0).astype(np.int64)
    return dict(name="sharded lane", keys=[auction.astype(np.int64),
                                           ws.astype(np.int64)],
                hash=None, valid=valid, signs=signs,
                prims=[("add", 0, counts)])


def k5_torch_args(torch, case: dict, device) -> tuple:
    """A ``k5_cases`` case as K5's arguments on ``device``: ``(sort_key,
    perm, key_cols, valid, signs, modes, inits, values)``, sorted by
    ``sort_by_hash``."""
    from risingwave_tpu_torch.common.chunk import NCol, StrCol
    from risingwave_tpu_torch.common.hash import hash64_columns
    from risingwave_tpu_torch.stream.hash_agg import sort_by_hash

    def col(c):
        if isinstance(c, tuple) and c[0] == "str":
            return StrCol(torch.from_numpy(c[1]).to(device),
                          torch.from_numpy(c[2]).to(device))
        if isinstance(c, tuple):
            return NCol(col(c[1]), torch.from_numpy(c[2]).to(device))
        return torch.from_numpy(c).to(device)

    keys = [col(c) for c in case["keys"]]
    valid = torch.from_numpy(case["valid"]).to(device)
    h = hash64_columns(keys) if case["hash"] is None \
        else torch.from_numpy(case["hash"]).to(device)
    sk, perm = sort_by_hash(h, valid)
    modes = [m for m, _, _ in case["prims"]]
    inits = [i for _, i, _ in case["prims"]]
    values = [torch.from_numpy(v).to(device) for _, _, v in case["prims"]]
    return (sk, perm, keys, valid, torch.from_numpy(case["signs"]).to(device),
            modes, inits, values)


#: K5's float64 sums may differ from the plain version's cumsum differences
#: in their last bits (another summation order): compared within this
#: relative and absolute tolerance; every other output exactly
K5_F64_RTOL, K5_F64_ATOL = 1e-12, 1e-9


def preagg_pairs(torch, tag: str, a, b, modes, values) -> list:
    """K5's outputs ``a`` against ``b`` as ``max_abs_err`` pairs; float64
    sums checked here within ``K5_F64_RTOL`` / ``K5_F64_ATOL``."""
    from risingwave_tpu_torch.common.tree import flatten

    pairs = [(f"{tag} {nm}", getattr(a, nm), getattr(b, nm))
             for nm in ("s_hash", "starts", "rep", "seg_rows", "seg_signs")]
    for i, (x, y) in enumerate(zip(a.s_keys, b.s_keys)):
        for j, (xl, yl) in enumerate(zip(flatten(x)[0], flatten(y)[0])):
            pairs.append((f"{tag} key {i}.{j}", xl, yl))
    for i, (mode, x, y) in enumerate(zip(modes, a.seg_values,
                                         b.seg_values)):
        if x.dtype == torch.float64 and mode == "add":
            if not bool(torch.isclose(x, y, rtol=K5_F64_RTOL,
                                      atol=K5_F64_ATOL).all()):
                d = (x - y).abs().max().item()
                fail(f"{tag} prim {i}: float64 sum off by {d}")
            continue
        if x.dtype == torch.float64:
            x, y = x.view(torch.int64), y.view(torch.int64)
        pairs.append((f"{tag} prim {i}", x, y))
    return pairs


def phase_preagg(torch, device, timer, scale):
    """K5 on every ``k5_cases`` case, at the pane agg's chunk shape (8192
    rows on (auction, window), 99 in 100 on the hot auction), at the final
    agg's (the 5x hop expansion of a 2 x 4096-row U-/U+ flush, half of it
    invisible) and at q5 sharded's keyed half on one lane (163,840
    received rows, ~420 valid), each against its plain version (float64
    sums within ``K5_F64_RTOL``); the pane and lane shapes timed."""
    from risingwave_tpu_torch.common.hash import hash64_columns
    from risingwave_tpu_torch.stream.hash_agg import (
        INT64_MIN, agg_preagg_cuda, agg_preagg_plain, sort_by_hash)

    g = torch.Generator(device="cpu").manual_seed(5)

    def case(cap, signed):
        hot = torch.rand(cap, generator=g) < 0.99
        auction = torch.where(hot, torch.tensor(1300),
                              torch.randint(1000, 1400, (cap,), generator=g))
        ws = torch.randint(0, 3, (cap,), generator=g) * HOP_SLIDE_US \
            + 1_436_918_400_000_000
        valid = torch.rand(cap, generator=g) < (0.5 if signed else 0.98)
        signs = torch.where(torch.rand(cap, generator=g) < 0.5,
                            torch.tensor(-1), torch.tensor(1)) if signed \
            else torch.ones(cap, dtype=torch.int64)
        signs = torch.where(valid, signs, torch.zeros_like(signs))
        price = torch.randint(100, 10**8, (cap,), generator=g)
        qty = torch.randint(-2**31, 2**31 - 1, (cap,), generator=g,
                            dtype=torch.int32)
        to = lambda t: t.to(device)  # noqa: E731
        keys = [to(auction), to(ws)]
        valid, signs = to(valid), to(signs.to(torch.int32))
        sig64 = signs.to(torch.int64)
        modes = ["add", "max", "min"]
        inits = [0, INT64_MIN, 2**31 - 1]
        values = [sig64, torch.where(sig64 > 0, to(price),
                                     torch.full_like(sig64, INT64_MIN)),
                  to(qty)]
        sk, perm = sort_by_hash(hash64_columns(keys), valid)
        return (sk, perm, keys, valid, signs, modes, inits, values)

    kernel = agg_preagg_cuda if device.type == "cuda" else agg_preagg_plain
    pairs = []
    lane_n = 163_840 // scale
    lane_args = k5_torch_args(torch, k5_lane_case(lane_n, 420 // scale,
                                                  seed=59), device)
    shaped = [("pane", case(8192 // scale, False)),
              ("final", case(5 * 2 * 4096 // scale, True)),
              ("lane", lane_args)]
    cases = k5_cases()
    shaped += [(c["name"], k5_torch_args(torch, c, device)) for c in cases]
    for tag, args in shaped:
        a, b = kernel(*args), agg_preagg_plain(*args)
        pairs += preagg_pairs(torch, f"preagg {tag}", a, b, args[5],
                              args[7])
        if tag == "pane":
            pane_args, n_reps = args, int(b.rep.sum())
        elif tag == "lane":
            lane_reps = int(b.rep.sum())
    err = max_abs_err(torch, pairs)
    ms = timer(lambda i: kernel(*pane_args), 200)
    plain_ms = timer(lambda i: agg_preagg_plain(*pane_args), 20)
    lane_ms = timer(lambda i: kernel(*lane_args), 100)
    lane_plain_ms = timer(lambda i: agg_preagg_plain(*lane_args), 5)
    cap = pane_args[0].shape[0]
    # per row read: sorted key 8, perm 8, two keys 16, valid 1, sign 4,
    # prims 8 + 8 + 4; written: sorted keys 16, hash 8, rep 1, starts 1,
    # rows 8, signs 8, prims 8 + 8 + 4; ~40 integer ops per row
    b = bound(cap * (57 + 62), cap * 40)
    # the lane: the same with one 8-byte primitive: 45 B read, 50 written
    lb = bound(lane_n * (45 + 50), lane_n * 40)
    print(f"[agg_preagg] exact (pane, final-agg and sharded-lane shapes, "
          f"{len(cases)} edge cases; float64 sums within "
          f"{K5_F64_RTOL} relative; {n_reps} representatives of {cap} "
          f"rows); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{b[0]:.5f} ms; lane ({lane_n} rows, {lane_reps} "
          f"representatives) kernel {lane_ms:.4f} ms, plain "
          f"{lane_plain_ms:.4f} ms, bound {lb[0]:.5f} ms", flush=True)
    out = kernel_entry("agg_preagg.cu",
                       "risingwave_tpu/stream/hash_agg.py:394", ms,
                       plain_ms, b, None, err)
    out.update(lane_ms=lane_ms, lane_plain_ms=lane_plain_ms,
               lane_bound_ms=lb[0], cases=len(cases))
    return out

def phase_mask_indices(torch, device, timer, scale):
    """K7 over the agg's 2^18 dirty mask: fewer set bits than the emit
    capacity (one flush round) and more (a drain)."""
    from risingwave_tpu_torch.common.compact import (
        mask_indices, mask_indices_plain)

    g = torch.Generator(device="cpu").manual_seed(6)
    size, k = (1 << 18) // scale, 4096 // scale
    pairs = []
    for density in (3000 / (1 << 18), 0.05):
        mask = (torch.rand(size, generator=g) < density).to(device)
        pairs.append((f"mask_indices density {density:.4f}",
                      mask_indices(mask, k, size),
                      mask_indices_plain(mask, k, size)))
    err = max_abs_err(torch, pairs)
    mask = (torch.rand(size, generator=g) < 3000 / (1 << 18)).to(device)
    ms = timer(lambda i: mask_indices(mask, k, size), 200)
    plain_ms = timer(lambda i: mask_indices_plain(mask, k, size), 50)
    library_ms = timer(lambda i: torch.nonzero(mask)[:k], 200)
    b = bound(size + 4 * k, size * 4)
    print(f"[mask_indices] exact; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, library {library_ms:.4f} ms (torch.nonzero, which syncs "
          f"with the host), bound {b[0]:.5f} ms", flush=True)
    return kernel_entry("compact.cu", "risingwave_tpu/common/compact.py:32",
                        ms, plain_ms, b, library_ms, err)


def _k8_col(rng, kind: str, width: int, nullable: bool, n: int):
    """``n`` random values of one K8-ring case column (numpy): an array,
    a string as (bytes [n, width] uint8 with random bytes past the
    lengths, lens int32), a nullable column as ("null", payload, mask)."""
    import numpy as np

    if kind == "VARCHAR":
        col = (rng.integers(0, 256, (n, width)).astype(np.uint8),
               rng.integers(0, width + 1, n).astype(np.int32))
    elif kind == "INT32":
        col = rng.integers(-2**31, 2**31, n).astype(np.int32)
    elif kind == "BOOLEAN":
        col = rng.random(n) < 0.5
    elif kind == "FLOAT64":
        col = rng.standard_normal(n) * 1e6
    else:
        col = rng.integers(-2**62, 2**62, n).astype(np.int64)
    if nullable:
        return ("null", col, rng.random(n) < 0.3)
    return col


#: the ring shapes chip_smoke times: q1's 4 int64 columns, and q22's MV
#: row (3 int64, a 16-byte channel and three 40-byte directories: 176 B
#: with the lengths)
Q1_RING_FIELDS = tuple((n, "INT64", 0, False)
                       for n in ("auction", "bidder", "price", "ts"))
Q22_RING_FIELDS = (("auction", "INT64", 0, False),
                   ("bidder", "INT64", 0, False),
                   ("price", "INT64", 0, False),
                   ("channel", "VARCHAR", 16, False),
                   ("dir1", "VARCHAR", 40, False),
                   ("dir2", "VARCHAR", 40, False),
                   ("dir3", "VARCHAR", 40, False))


def k8_ring_cases() -> list:
    """K8-ring's corner cases, shared with
    ``tests/test_torch_ring_pool_grid.py``: dicts with ``fields`` ((name,
    type, str_width, nullable) each), ``ring`` (a power of two), the
    ``cursor`` and ``overflow`` to start from, ``init`` the ring's columns
    before the first chunk, and ``chunks``, a list of (columns, valid)
    (columns as ``_k8_col`` makes them).  The kernel's tiles are 256
    rows: capacities of 40 to 1000 rows give one to four tiles."""
    import numpy as np

    i64 = ("INT64", 0, False)
    specs = [
        # a chunk that wraps the ring's end
        ("wrap", [("a",) + i64, ("b",) + i64], 64, 50, 0,
         [(40, 0.8), (40, 0.8)]),
        # a cursor past the ring: lost_before > 0
        ("lapped", [("a",) + i64, ("s", "VARCHAR", 40, False)], 128, 300,
         172, [(100, 0.7), (100, 0.9)]),
        ("all_invalid_all_valid", [("a",) + i64, ("b",) + i64], 256, 10, 0,
         [(96, 0.0), (96, 1.0)]),
        # widths that divide no word (3, 40 B: 1- and 8-byte words) and one
        # that divides 16 (64 B)
        ("strings", [("a",) + i64, ("s3", "VARCHAR", 3, False),
                     ("s40", "VARCHAR", 40, False),
                     ("s64", "VARCHAR", 64, False)], 512, 400, 0,
         [(300, 0.6), (300, 0.95)]),
        ("nullable", [("a", "INT64", 0, True), ("s", "VARCHAR", 40, True),
                      ("i", "INT32", 0, True)], 256, 200, 0,
         [(150, 0.8), (150, 0.5)]),
        ("types", [("i", "INT32", 0, False), ("b", "BOOLEAN", 0, False),
                   ("f", "FLOAT64", 0, False), ("g", "FLOAT64", 0, True)],
         1024, 1000, 0, [(130, 0.9), (130, 0.9)]),
        # a capacity that is not a multiple of the tile, over four tiles
        ("odd_capacity", [(n,) + i64 for n in "abcd"], 4096, 3000, 0,
         [(1000, 0.97), (1000, 0.5), (1000, 0.97)]),
    ]
    out = []
    for seed, (name, fields, ring, cursor, overflow, chunks) in \
            enumerate(specs):
        rng = np.random.default_rng(800 + seed)
        init = [_k8_col(rng, k, w, nl, ring) for _, k, w, nl in fields]
        script = []
        for cap, p in chunks:
            cols = [_k8_col(rng, k, w, nl, cap) for _, k, w, nl in fields]
            script.append((cols, rng.random(cap) < p))
        out.append(dict(name=name, fields=fields, ring=ring, cursor=cursor,
                        overflow=overflow, init=init, chunks=script))
    return out


def k8_schema(fields):
    """The port's Schema of K8-ring case fields."""
    from risingwave_tpu_torch.common.types import DataType, Field, Schema

    return Schema(tuple(Field(n, getattr(DataType, k), str_width=w or 16,
                              nullable=nl) for n, k, w, nl in fields))


def k8_torch_col(torch, col, device):
    """A ``_k8_col`` column as the port's column on ``device``."""
    from risingwave_tpu_torch.common.chunk import NCol, StrCol

    def t(a):
        return torch.from_numpy(a.copy()).to(device)

    if isinstance(col, tuple) and isinstance(col[0], str):
        return NCol(k8_torch_col(torch, col[1], device), t(col[2]))
    if isinstance(col, tuple):
        return StrCol(t(col[0]), t(col[1]))
    return t(col)


def k8_torch_case(torch, case: dict, device):
    """(values, cursor, overflow, chunks) of a K8-ring case for the port:
    the ring's columns, two int64 scalars and the Chunks."""
    from risingwave_tpu_torch.common.chunk import Chunk

    schema = k8_schema(case["fields"])
    values = tuple(k8_torch_col(torch, c, device) for c in case["init"])
    i64 = dict(dtype=torch.int64, device=device)
    chunks = []
    for cols, valid in case["chunks"]:
        cap = valid.shape[0]
        chunks.append(Chunk(
            tuple(k8_torch_col(torch, c, device) for c in cols),
            torch.zeros(cap, dtype=torch.int8, device=device),
            torch.from_numpy(valid.copy()).to(device), schema))
    return (values, torch.tensor(case["cursor"], **i64),
            torch.tensor(case["overflow"], **i64), chunks)


def _ring_pairs(torch, tag, a, b):
    """Named (kernel, plain) tensors of two K8-ring states: every leaf
    (floats as bit patterns), the cursor and the lap count."""
    from risingwave_tpu_torch.common.tree import flatten

    def bits(x):
        if x.dtype.is_floating_point:
            return x.view(torch.int64 if x.element_size() == 8
                          else torch.int32)
        return x

    la, lb = flatten(a[0])[0], flatten(b[0])[0]
    pairs = [(f"{tag} leaf {i}", bits(x), bits(y))
             for i, (x, y) in enumerate(zip(la, lb))]
    pairs += [(f"{tag} cursor", a[1], b[1]), (f"{tag} overflow", a[2], b[2])]
    # copies: the states change after this call
    return [(n, x.clone(), y.clone()) for n, x, y in pairs]


def ring_shape(torch, device, fields, cap: int, ring: int, seed: int):
    """A chunk of ``cap`` rows of ``fields`` (97% visible) and an empty
    ring state whose cursor stands a third of a chunk before a lap."""
    import numpy as np

    from risingwave_tpu_torch.common.chunk import Chunk
    from risingwave_tpu_torch.stream.materialize import empty_value_col

    rng = np.random.default_rng(seed)
    schema = k8_schema(fields)
    cols = tuple(k8_torch_col(torch, _k8_col(rng, k, w, nl, cap), device)
                 for _, k, w, nl in fields)
    chunk = Chunk(cols, torch.zeros(cap, dtype=torch.int8, device=device),
                  torch.from_numpy(rng.random(cap) < 0.97).to(device),
                  schema)
    values = tuple(empty_value_col(f, ring, device) for f in schema)
    i64 = dict(dtype=torch.int64, device=device)
    return (values, torch.tensor(ring - cap // 3, **i64),
            torch.tensor(5, **i64)), chunk


#: K8-ring's backfill chunk on the card and the ring it wraps
RING_BACKFILL_ROWS, RING_BACKFILL_RING = 1 << 18, 1 << 19


def phase_ring(torch, device, timer, scale):
    """K8-ring exactly against its plain version on every
    ``k8_ring_cases`` case, at q1's (8192 rows of 4 int64 columns) and
    q22's (8192 rows of 176 B with strings) shapes into the 2^23 ring,
    starting just before a lap so positions wrap (both shapes timed), and
    on the card with a backfill chunk of 2^18 q22 rows (1024 tiles, so a
    tile's look-back may pass more than 32 tiles without a prefix) into a
    2^19 ring that it wraps."""
    from risingwave_tpu_torch.common.tree import tree_map
    from risingwave_tpu_torch.stream.materialize import (
        ring_append, ring_append_plain)

    pairs = []
    cases = k8_ring_cases()
    for case in cases:
        *a, chunks = k8_torch_case(torch, case, device)
        b = tree_map(torch.clone, tuple(a))
        for k, c in enumerate(chunks):
            ring_append(*a[:3], c, case["ring"])
            ring_append_plain(*b[:3], c, case["ring"])
            pairs += _ring_pairs(torch, f"ring {case['name']} chunk {k}",
                                 a, b)
    ring, cap = (1 << 23) // scale, 8192 // scale
    shapes = {}
    for tag, fields in (("q1", Q1_RING_FIELDS), ("q22", Q22_RING_FIELDS)):
        st, chunk = ring_shape(torch, device, fields, cap, ring, 7)
        a, b = st, tree_map(torch.clone, st)
        for _ in range(2):
            ring_append(*a, chunk, ring)
            ring_append_plain(*b, chunk, ring)
        max_abs_err(torch, _ring_pairs(torch, f"ring {tag}", a, b))
        ms = timer(lambda i: ring_append(*a, chunk, ring), 200)
        plain_ms = timer(lambda i: ring_append_plain(*b, chunk, ring), 20)
        n = int(chunk.valid.sum())
        row = sum(row_bytes(c) for c in chunk.columns)
        # the valid bytes read, the visible rows read and written once
        shapes[tag] = dict(ms=ms, plain_ms=plain_ms, row_bytes=row,
                           bound=bound(cap + 2 * n * row, cap * 10))
    backfill = ""
    if device.type == "cuda":
        cap, ring = RING_BACKFILL_ROWS, RING_BACKFILL_RING
        a, chunk = ring_shape(torch, device, Q22_RING_FIELDS, cap, ring, 8)
        b = tree_map(torch.clone, a)
        for k in range(3):
            ring_append(*a, chunk, ring)
            ring_append_plain(*b, chunk, ring)
            pairs += _ring_pairs(torch, f"ring backfill chunk {k}", a, b)
        backfill = f", a {cap}-row backfill chunk into a {ring} ring (x3)"
    err = max_abs_err(torch, pairs)
    q1, q22 = shapes["q1"], shapes["q22"]
    print(f"[ring_append] exact (every leaf, null plane, cursor and lap "
          f"count) on {len(cases)} edge cases{backfill} and at q1's and "
          f"q22's shapes; q1 ({q1['row_bytes']:.0f} B rows) kernel "
          f"{q1['ms']:.4f} ms, plain {q1['plain_ms']:.4f} ms, bound "
          f"{q1['bound'][0]:.5f} ms; q22 ({q22['row_bytes']:.0f} B rows) "
          f"kernel {q22['ms']:.4f} ms, plain {q22['plain_ms']:.4f} ms, "
          f"bound {q22['bound'][0]:.5f} ms (the one-block kernel before "
          f"it: 0.0181 ms at q1's shape, 0.72 ms a q22 chunk, PERF.md)",
          flush=True)
    out = kernel_entry("compact.cu",
                       "risingwave_tpu/stream/materialize.py:224", q1["ms"],
                       q1["plain_ms"], q1["bound"], None, err)
    out.update(q22_ms=q22["ms"], q22_plain_ms=q22["plain_ms"],
               q22_bound_ms=q22["bound"][0], cases=len(cases))
    return out


def phase_bids(torch, device, timer, scale):
    """K9 against the plain generator on the card over 2^20 consecutive
    bids (every price bit for bit), and a seeded chunk far out."""
    from risingwave_tpu_torch.common.chunk import StrCol
    from risingwave_tpu_torch.connector.nexmark import (
        NexmarkConfig, NexmarkGenerator)

    def columns(c):
        out = [("ops", c.ops), ("valid", c.valid)]
        for name, col in zip(c.schema.names(), c.columns):
            if isinstance(col, StrCol):
                out += [(f"{name} bytes", col.data), (f"{name} lens",
                                                      col.lens)]
            else:
                out.append((name, col))
        return out

    gen = NexmarkGenerator(device=device)
    seeded = NexmarkGenerator(NexmarkConfig(inter_event_us=1, seed=3),
                              device=device)
    n = (1 << 20) // scale
    pairs = []
    for tag, gn, k0, cap in (("2^20 bids", gen, 0, n),
                             ("seeded", seeded, 10**9 + 7, 8192 // scale)):
        for (name, x), (_, y) in zip(columns(gn.gen_bids(k0, cap)),
                                     columns(gn.gen_bids_plain(k0, cap))):
            pairs.append((f"bids {tag} {name}", x, y))
    err = max_abs_err(torch, pairs)
    cap = 8192 // scale
    ms = timer(lambda i: gen.gen_bids(i * cap, cap), 200)
    plain_ms = timer(lambda i: gen.gen_bids_plain(i * cap, cap), 20)
    # per row written: 4 int64 columns, 16 + 40 string bytes, 2 lengths,
    # ops and valid; ~80 integer ops and one pow
    b = bound(cap * (32 + 56 + 8 + 2), cap * 100)
    print(f"[nexmark_bids] exact over {n} bids (prices bit for bit); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{b[0]:.5f} ms", flush=True)
    return kernel_entry("nexmark_bids.cu",
                        "risingwave_tpu/connector/nexmark.py:249", ms,
                        plain_ms, b, None, err)


def phase_hop(torch, device, timer, scale):
    """K10: the pane deltas' 5x expansion (8192 interleaved U-/U+ rows,
    negative timestamps included) and q7's tumble (k = 1)."""
    from risingwave_tpu_torch.stream.executor import (
        hop_window, hop_window_plain)

    g = torch.Generator(device="cpu").manual_seed(8)
    cap = 8192 // scale
    pairs = []
    for tag, base in (("pane deltas", 1_436_918_400_000_000),
                      ("negative ts", -30_000_000)):
        auction = torch.randint(1000, 2000, (cap,), generator=g)
        ts = base + torch.randint(-20_000_000, 20_000_000, (cap,),
                                  generator=g)
        bids = torch.randint(0, 10**6, (cap,), generator=g)
        ops = torch.tensor([2, 3], dtype=torch.int8).repeat(cap // 2)
        valid = torch.rand(cap, generator=g) < 0.6
        args = ([c.to(device) for c in (auction, ts, bids)], ops.to(device),
                valid.to(device), ts.to(device))
        for k, slide, size in ((5, HOP_SLIDE_US, WINDOW_US),
                               (1, WINDOW_US, WINDOW_US)):
            a = hop_window(*args, k, slide, size)
            b = hop_window_plain(*args, k, slide, size)
            flat = lambda r: list(r[0]) + list(r[1:])  # noqa: E731
            pairs += [(f"hop {tag} k={k} plane {i}", x, y)
                      for i, (x, y) in enumerate(zip(flat(a), flat(b)))]
        if tag == "pane deltas":
            pane_args = args
    err = max_abs_err(torch, pairs)
    ms = timer(lambda i: hop_window(*pane_args, 5, HOP_SLIDE_US, WINDOW_US),
               200)
    plain_ms = timer(lambda i: hop_window_plain(*pane_args, 5, HOP_SLIDE_US,
                                                WINDOW_US), 50)
    # read 3 int64 columns + ops + valid per row; write them 5 times with
    # the two window columns
    b = bound(cap * 26 + 5 * cap * (26 + 16), 5 * cap * 10)
    print(f"[hop_window] exact (k=5 pane deltas and k=1 tumble, negative "
          f"timestamps); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {b[0]:.5f} ms", flush=True)
    return kernel_entry("hop_window.cu",
                        "risingwave_tpu/stream/executor.py:142", ms,
                        plain_ms, b, None, err)


# ---------------------------------------------------------------------------
# 3-5. card against CPU, main paths, result checks


BENCH_SOURCES = """
CREATE SOURCE bid (
    auction BIGINT, bidder BIGINT, price BIGINT,
    channel VARCHAR, url VARCHAR, date_time TIMESTAMP,
    WATERMARK FOR date_time AS date_time - INTERVAL '4' SECOND
) WITH (connector = 'nexmark', nexmark.table = 'bid',
        nexmark.event.rate = '1000000');
CREATE SOURCE person (
    id BIGINT, name VARCHAR, date_time TIMESTAMP,
    WATERMARK FOR date_time AS date_time - INTERVAL '4' SECOND
) WITH (connector = 'nexmark', nexmark.table = 'person',
        nexmark.event.rate = '1000000');
CREATE SOURCE auction (
    id BIGINT, seller BIGINT, reserve BIGINT, expires TIMESTAMP,
    date_time TIMESTAMP,
    WATERMARK FOR date_time AS date_time - INTERVAL '4' SECOND
) WITH (connector = 'nexmark', nexmark.table = 'auction',
        nexmark.event.rate = '1000000');
"""

#: bench.py's query texts
QUERY_SQL = {
    "q1": """
CREATE MATERIALIZED VIEW bench_mv AS
SELECT auction, bidder, 0.908 * price AS price, date_time
FROM bid;
""",
    "q5": """
CREATE MATERIALIZED VIEW bench_mv AS
SELECT auction, window_start, count(*) AS bids
FROM HOP(bid, date_time, INTERVAL '2' SECOND, INTERVAL '10' SECOND)
GROUP BY auction, window_start;
""",
    "q7": """
CREATE MATERIALIZED VIEW bench_mv AS
SELECT window_start, max(price) AS max_price, count(*) AS bids
FROM TUMBLE(bid, date_time, INTERVAL '10' SECOND)
GROUP BY window_start;
""",
    "q8": """
CREATE MATERIALIZED VIEW bench_mv AS
SELECT p.id AS id, p.name AS name, a.reserve AS reserve
FROM TUMBLE(person, date_time, INTERVAL '1' SECOND) p
JOIN TUMBLE(auction, date_time, INTERVAL '1' SECOND) a
ON p.id = a.seller AND p.window_start = a.window_start;
""",
    # Nexmark q19 as published; q18 as published less `extra`, which the
    # bid source lacks
    "q19": """
CREATE MATERIALIZED VIEW bench_mv AS
SELECT * FROM (SELECT *, ROW_NUMBER() OVER (PARTITION BY auction ORDER BY
               price DESC) AS rank_number FROM bid) WHERE rank_number <= 10;
""",
    "q18": """
CREATE MATERIALIZED VIEW bench_mv AS
SELECT auction, bidder, price, channel, url, date_time
FROM (SELECT *, ROW_NUMBER() OVER (PARTITION BY bidder, auction ORDER BY
      date_time DESC) AS rank_number FROM bid) WHERE rank_number <= 1;
""",
    # Nexmark q6's window (the average of a bidder's last 11 prices) over
    # a top-1 bid per auction: the auction x bid join cannot plan yet, so
    # the top-1 is taken over bids, and the window partitions by bidder
    # (bids carry no seller)
    "q6_bid": """
CREATE MATERIALIZED VIEW bench_mv AS
SELECT bidder, price, date_time,
       AVG(price) OVER (PARTITION BY bidder ORDER BY date_time
                        ROWS BETWEEN 10 PRECEDING AND CURRENT ROW) AS avg
FROM (SELECT *, ROW_NUMBER() OVER (PARTITION BY auction ORDER BY price DESC)
      AS rn FROM bid) WHERE rn <= 1;
""",
    # per-auction window functions over the bid stream
    "ow_bid": """
CREATE MATERIALIZED VIEW bench_mv AS
SELECT auction, bidder, price, date_time,
  row_number() OVER (PARTITION BY auction ORDER BY date_time) AS rn,
  rank() OVER (PARTITION BY auction ORDER BY date_time) AS rk,
  dense_rank() OVER (PARTITION BY auction ORDER BY date_time) AS drk,
  lag(price) OVER (PARTITION BY auction ORDER BY date_time) AS prev_price,
  lead(price) OVER (PARTITION BY auction ORDER BY date_time) AS next_price,
  max(price) OVER (PARTITION BY auction ORDER BY date_time) AS max_so_far,
  sum(price) OVER (PARTITION BY auction ORDER BY date_time) AS sum_so_far,
  count(*) OVER (PARTITION BY auction ORDER BY date_time) AS n_so_far
FROM bid;
""",
}


def _host_value(v):
    return float(v) if isinstance(v, float) else int(v)


def phase_engine_parity(torch, device, query: str) -> None:
    """``query`` at 2 events/s through the engine on ``device`` and on
    the CPU (plain versions, the agg forced onto the pre-aggregation
    branch the card takes), small tables: hundreds of windows, watermark
    cleaning, tombstones, rehash at maintenance and multi-round emit
    drains all run through the kernels.  MV rows and every state tensor
    must be equal."""
    from risingwave_tpu_torch.compat import state_mismatches, state_to_numpy
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig
    from risingwave_tpu_torch.stream import hash_agg

    cfg = PlannerConfig(chunk_capacity=256, agg_table_size=1 << 10,
                        agg_emit_capacity=16,
                        mv_table_size=1 << (14 if query == "q5" else 10),
                        mv_ring_size=1 << 14)
    engines = []
    card_branch = hash_agg.accel_tuned
    for dev in (device, torch.device("cpu")):
        if dev.type == "cpu":
            hash_agg.accel_tuned = lambda d: True
        try:
            eng = Engine(cfg, device=dev)
            eng.execute(BENCH_SOURCES.replace("'1000000'", "'2'"))
            eng.execute(QUERY_SQL[query])
            eng.tick(barriers=10, chunks_per_barrier=4)
        finally:
            hash_agg.accel_tuned = card_branch
        engines.append(eng)
    rows = [sorted(tuple(_host_value(v) for v in r)
                   for r in e.execute("SELECT * FROM bench_mv"))
            for e in engines]
    if rows[0] != rows[1] or not rows[0]:
        fail(f"{query} MV on the card differs from the CPU plain versions")
    bad = state_mismatches(state_to_numpy(engines[1].jobs[0].states),
                           engines[0].jobs[0].states)
    if bad:
        fail(f"{query} state on the card differs from the CPU: {bad[:5]}")
    tombs = [int(s.table.tombstone_count())
             for s in engines[0].jobs[0].states if hasattr(s, "table")]
    print(f"[parity] {query} at 2 events/s, 10 barriers: {len(rows[0])} MV "
          f"rows and all state equal to the CPU plain versions (tombstones "
          f"left per table after rehash: {tombs})", flush=True)


#: the port's own kernels, by CUDA function name
PORT_KERNEL_NAMES = ("hash64_kernel", "probe_walk", "probe_claim",
                     "reset_kernel",
                     "scatter_kernel", "mark_kernel", "apply_kernel",
                     "preagg_kernel", "count_kernel", "write_kernel",
                     "ring_append_kernel", "bids_kernel", "hop_kernel",
                     "auctions_kernel", "persons_kernel", "tag_lookup_kernel",
                     "tag_insert_kernel", "ranked_insert",
                     "join_rank_kernel", "join_count", "join_place",
                     "join_degree",
                     "join_emit_kernel", "join_clean_kernel",
                     "compact_count_kernel", "compact_tiles_kernel",
                     "compact_write_kernel", "topn_", "ow_scan",
                     "ow_finish", "table_sweep_kernel",
                     "distinct_", "dyn_", "str_cmp_kernel", "str_case_kernel",
                     "split_part_kernel", "to_char_kernel",
                     "regexp_group_kernel", "replace_kernel",
                     "str_match_kernel", "like_kernel", "str_window_kernel",
                     "calendar_kernel", "minput_",
                     "eowc_", "sink_")


#: device microseconds and launches by kernel name of the last profiled
#: window (``profile_window``)
LAST_PROFILE: dict = {}


def profile_window(torch, eng, query: str, barriers: int = 2,
                   chunks_per_barrier: int = CHUNKS_PER_BARRIER
                   ) -> float | None:
    """More barriers under torch.profiler: device busy time (the sum of
    CUDA kernel times on the one stream), kernels launched per chunk
    (``chunks_per_barrier`` chunks a barrier: q8 pulls 4 a round), the
    share of the port's own kernels, and the top kernels.  The profiler
    slows the host, so its wall time is only the denominator of the busy
    share it reports, not a rate.  Returns the launches per chunk (None
    when the profiler recorded no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.tick(barriers=barriers, chunks_per_barrier=CHUNKS_PER_BARRIER)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and dev_us(e) > 0]
    LAST_PROFILE.clear()
    LAST_PROFILE.update({kernel_name(e.key).split("(")[0]:
                         (dev_us(e), e.count)
                         for e in kern})
    busy_ms = sum(dev_us(e) for e in kern) / 1e3
    if busy_ms == 0:
        print(f"[profile] {query}: device time not measured (no CUDA "
              "kernel recorded)", flush=True)
        return None
    ours_ms = sum(dev_us(e) for e in kern
                  if kernel_name(e.key).startswith(PORT_KERNEL_NAMES)) / 1e3
    n_kern = sum(e.count for e in kern)
    chunks = barriers * chunks_per_barrier
    print(f"[profile] {query} {barriers} barriers x {chunks_per_barrier} "
          f"chunks: "
          f"wall {wall_ms:.2f} ms (profiled), device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), port kernels {ours_ms:.3f} "
          f"ms, {n_kern} kernel launches ({n_kern / chunks:.1f} per "
          f"chunk)", flush=True)
    for e in sorted(kern, key=lambda e: -dev_us(e))[:12]:
        print(f"[profile]   {dev_us(e) / 1e3:8.3f} ms  x{e.count:5d}  "
              f"{e.key[:100]}", flush=True)

    job = eng.jobs[0]
    if not hasattr(job, "fragment") or not hasattr(job.source, "gen"):
        return n_kern / chunks
    # launches by layer for one chunk (the step runs on a clone: the
    # job's own state must stay as the timed run left it)
    from risingwave_tpu_torch.common.tree import tree_map

    gen, cap = job.source.gen, job.source.cap
    states = tree_map(torch.clone, job.states)
    chunk = gen.gen_bids(0, cap)
    for name, fn in (("generator", lambda: gen.gen_bids(0, cap)),
                     ("fragment step", lambda: job.fragment.step(states,
                                                                 chunk))):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        k = [e for e in prof.key_averages()
             if getattr(e, "device_type", None) == DeviceType.CUDA]
        print(f"[profile] {query} one chunk, {name}: "
              f"{sum(e.count for e in k)} kernel launches, "
              f"{sum(dev_us(e) for e in k) / 1e3:.3f} ms device", flush=True)
    return n_kern / chunks


def _consumed_bids(eng, cap: int, reader=None):
    """numpy columns of every bid the job consumed (its source, or
    ``reader``), regenerated."""
    import numpy as np

    reader = reader or eng.jobs[0].source
    cols = {"auction": [], "bidder": [], "price": [], "ts": []}
    for i in range(reader.offset // cap):
        c = reader.gen.gen_bids(i * cap, cap)
        for name, j in (("auction", 0), ("bidder", 1), ("price", 2),
                        ("ts", 5)):
            cols[name].append(c.columns[j].cpu().numpy())
    return {k: np.concatenate(v) for k, v in cols.items()}


def check_q7(eng, bids) -> str:
    import numpy as np

    got = sorted(tuple(int(v) for v in r)
                 for r in eng.execute("SELECT * FROM bench_mv"))
    ws = bids["ts"] - bids["ts"] % WINDOW_US
    want = []
    for w in np.unique(ws):
        sel = ws == w
        want.append((int(w), int(bids["price"][sel].max()), int(sel.sum())))
    if got != want:
        fail(f"q7 MV differs from the numpy recomputation: {got[:4]} vs "
             f"{want[:4]}")
    return (f"MV equals numpy max/count per window over "
            f"{bids['price'].shape[0]} bids ({len(want)} windows)")


def check_q5(eng, bids, mv: str = "bench_mv") -> str:
    import numpy as np

    k = WINDOW_US // HOP_SLIDE_US
    ws0 = bids["ts"] - bids["ts"] % HOP_SLIDE_US
    base = int(ws0.min()) - (k - 1) * HOP_SLIDE_US
    n_win = (int(ws0.max()) - base) // HOP_SLIDE_US + 1
    # pack (auction, window index) into one int64 per hop copy
    win = np.concatenate([(ws0 - i * HOP_SLIDE_US - base) // HOP_SLIDE_US
                          for i in range(k)])
    key = np.tile(bids["auction"], k) * n_win + win
    uniq, counts = np.unique(key, return_counts=True)
    rows = eng.execute(f"SELECT auction, window_start, bids FROM {mv}")
    got = np.asarray([(int(a) * n_win + (int(w) - base) // HOP_SLIDE_US,
                       int(c)) for a, w, c in rows], np.int64)
    got = got[np.argsort(got[:, 0])] if len(got) else got.reshape(0, 2)
    if got.shape[0] != uniq.shape[0] or not (
            np.array_equal(got[:, 0], uniq)
            and np.array_equal(got[:, 1], counts)):
        fail(f"q5 MV ({got.shape[0]} rows) differs from the numpy hop "
             f"counts ({uniq.shape[0]} (auction, window) pairs)")
    return (f"MV equals numpy hop counts per (auction, window_start) over "
            f"{bids['auction'].shape[0]} bids ({uniq.shape[0]} rows)")


def check_q1(eng, bids) -> str:
    import numpy as np

    entry = eng.catalog.get("bench_mv")
    state = eng.jobs[0].states[entry.mv_state_index[0]]
    n = int(state.cursor)
    if n != bids["price"].shape[0] or int(state.overflow) != 0 \
            or n > entry.mv_executor.ring_size:
        fail(f"q1 ring holds {n} rows (overflow {int(state.overflow)}) for "
             f"{bids['price'].shape[0]} bids")
    # 0.908 * price at the engine scale: round(908000 * price * 10^6 / 10^6)
    price = np.round(np.float64(908_000) * (bids["price"] * 10**6).astype(
        np.float64) / 1e6).astype(np.int64)
    for name, col, want in (("auction", 0, bids["auction"]),
                            ("bidder", 1, bids["bidder"]),
                            ("price", 2, price), ("date_time", 3, bids["ts"])):
        got = state.values[col][:n].cpu().numpy()
        if not np.array_equal(got, want):
            fail(f"q1 ring column {name} differs from numpy")
    return f"ring rows equal numpy 0.908 * price over {n} bids, no lap"


def phase_main_path(torch, device, scale, query: str):
    from risingwave_tpu_torch import kernels
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig

    cfg = {k: v // scale for k, v in BENCH_CONFIG.items()}
    cfg["mv_ring_size"] = (1 << (23 if query == "q1" else 21)) // scale
    eng = Engine(PlannerConfig(**cfg), device=device)
    eng.execute(BENCH_SOURCES)
    eng.execute(QUERY_SQL[query])
    eng.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1000000")
    eng.execute("ALTER SYSTEM SET snapshot_interval_checkpoints = 8")
    eng.tick(barriers=WARMUP_BARRIERS if device.type == "cuda" else 1,
             chunks_per_barrier=CHUNKS_PER_BARRIER)
    if device.type == "cuda":
        torch.cuda.synchronize()
    kernels.reset_launches()
    barriers = BARRIERS if device.type == "cuda" else 2
    t0 = time.perf_counter()
    eng.tick(barriers=barriers, chunks_per_barrier=CHUNKS_PER_BARRIER)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    cap = cfg["chunk_capacity"]
    chunks = barriers * CHUNKS_PER_BARRIER
    rows = chunks * cap
    rate = rows / dt
    print(f"[main] {query} {rows} rows in {dt:.3f} s = {rate:.0f} rows/s; "
          f"port kernel launches {launches}", flush=True)
    if device.type == "cuda":
        per_chunk = profile_window(torch, eng, query)
        print(f"[main] {query} launches per chunk "
              f"{'not measured' if per_chunk is None else f'{per_chunk:.1f}'}"
              f" (all CUDA kernels, profiled window)", flush=True)
    # post-window consistency audit: counters are read and raise on
    # overflow / inconsistency
    eng.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1")
    eng.tick(barriers=1, chunks_per_barrier=0)
    bids = _consumed_bids(eng, cap)
    msg = {"q1": check_q1, "q5": check_q5, "q7": check_q7}[query](eng, bids)
    print(f"[check] {query} {msg}", flush=True)
    del eng
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return launches, rate


# ---------------------------------------------------------------------------
# q8: the windowed person x auction join


#: bench.py's PlannerConfig for q8 (both join sides are pools of 2^22)
Q8_CONFIG = dict(chunk_capacity=8192, agg_table_size=1 << 18,
                 agg_emit_capacity=4096, join_left_table_size=1 << 22,
                 join_right_table_size=1 << 18, join_pool_size=1 << 22,
                 join_out_capacity=1 << 12, mv_table_size=1 << 18,
                 mv_ring_size=1 << 23, topn_pool_size=1 << 14)
#: the columns q8's sources keep (person: id, name, date_time; auction:
#: id, seller, reserve, expires, date_time)
PERSON_COLS = (0, 1, 6)
AUCTION_COLS = (0, 7, 4, 6, 5)
Q8_WINDOW_US = 1_000_000
WM_DELAY_US = 4_000_000


def _q8_engine(torch, device, scale, barriers: int):
    """A q8 engine at bench.py's sizes (divided by ``scale``) after
    ``barriers`` barriers of 8 scheduling rounds."""
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig

    cfg = {k: max(v // scale, 64) for k, v in Q8_CONFIG.items()}
    if scale > 1:
        # the CPU rehearsal's 1M events/s cover too little event time for
        # cleaning: pools and ring hold every row of the run instead
        cfg.update(join_pool_size=1 << 18, mv_ring_size=1 << 19)
    eng = Engine(PlannerConfig(**cfg), device=device)
    eng.execute(BENCH_SOURCES)
    eng.execute(QUERY_SQL["q8"])
    eng.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1000000")
    eng.execute("ALTER SYSTEM SET snapshot_interval_checkpoints = 8")
    eng.tick(barriers=barriers, chunks_per_barrier=CHUNKS_PER_BARRIER)
    return eng


def phase_nexmark_events(torch, device, timer, scale):
    """K9's auctions and persons against the plain generators on the
    card: q8's columns and all columns, 2^20 rows from 0 (every price bit
    for bit) and a seeded chunk far out."""
    from risingwave_tpu_torch.connector.nexmark import (
        NexmarkConfig, NexmarkGenerator)

    gen = NexmarkGenerator(device=device)
    seeded = NexmarkGenerator(NexmarkConfig(inter_event_us=1, seed=3),
                              device=device)
    n, cap = (1 << 20) // scale, 8192 // scale
    out = {}
    for table, cols_q8, row_bytes in (("auctions", AUCTION_COLS, 5 * 8 + 2),
                                      ("persons", PERSON_COLS,
                                       2 * 8 + 24 + 4 + 2)):
        pairs = []
        for tag, gn, k0, rows, cols in (
                (f"2^20 {table}, q8 columns", gen, 0, n, cols_q8),
                (f"{table}, all columns", gen, 12345, cap, None),
                (f"seeded {table}", seeded, 10**9 + 7, cap, cols_q8)):
            kern = getattr(gn, f"gen_{table}")(k0, rows, cols)
            plain = getattr(gn, f"gen_{table}_plain")(k0, rows, cols)
            pairs += [(f"{tag} {name}", x, y) for (name, x), (_, y)
                      in zip(_chunk_planes(kern), _chunk_planes(plain))]
        err = max_abs_err(torch, pairs)
        fn = getattr(gen, f"gen_{table}")
        pfn = getattr(gen, f"gen_{table}_plain")
        ms = timer(lambda i: fn(i * cap, cap, cols_q8), 200)
        plain_ms = timer(lambda i: pfn(i * cap, cap, cols_q8), 20)
        # written per row: the kept columns, ops and valid; ~60 integer
        # ops (auctions: and two pow) per row
        b = bound(cap * row_bytes, cap * 60)
        print(f"[nexmark_{table}] exact over {n} rows (q8 columns, all "
              f"columns, seeded); kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, bound {b[0]:.5f} ms", flush=True)
        line = {"auctions": "risingwave_tpu/connector/nexmark.py:279",
                "persons": "risingwave_tpu/connector/nexmark.py:312"}[table]
        out[f"nexmark_{table}"] = kernel_entry("nexmark_events.cu", line, ms,
                                               plain_ms, b, None, err)
    return out


def _chunk_planes(c):
    from risingwave_tpu_torch.common.chunk import StrCol

    out = [("ops", c.ops), ("valid", c.valid)]
    for name, col in zip(c.schema.names(), c.columns):
        if isinstance(col, StrCol):
            out += [(f"{name} bytes", col.data), (f"{name} lens", col.lens)]
        else:
            out.append((name, col))
    return out


def _side_planes(tag, s):
    """Every tensor of a pool side, flattened with names."""
    from risingwave_tpu_torch.stream.materialize import value_leaves

    out = [(f"{tag} tags", s.table.tags), (f"{tag} count", s.count),
           (f"{tag} pool_pos", s.pool_pos),
           (f"{tag} slot_clean", s.slot_clean),
           (f"{tag} pool_len", s.pool_len), (f"{tag} overflow", s.overflow),
           (f"{tag} inconsistency", s.inconsistency)]
    for i, col in enumerate(s.rows):
        for j, (d, n) in enumerate(value_leaves(col)):
            out.append((f"{tag} rows[{i}].{j}", d))
    return out


def k13_cases() -> list:
    """K13's corner cases, shared with ``tests/test_torch_probe_rounds.py``:
    ``(name, pool, pool_len, tags, chunks)`` for the left pool side of an
    inner pool/pool join on ``(k, w)`` of ``(k INT64, w TIMESTAMP, name
    VARCHAR(8))`` (``k13_chunk_arrays``), starting from the side's empty
    state with ``pool_len`` and, where given, the tag table's uint64
    ``tags`` set; a chunk is ``(k, ops or None, valid or None,
    capacity)``."""
    import numpy as np

    cases = []
    # a hot key as one segment, twice (ranks go on from the degree)
    rng = np.random.default_rng(41)
    chunks = []
    for _ in range(2):
        k = rng.integers(0, 10**6, 256)
        k[rng.permutation(256)[:200]] = 7
        chunks.append((k, None, None, 256))
    cases.append(("hot key", 1 << 10, 0, None, chunks))
    # the pool overflows mid-chunk: 8 of 24 accepted rows fit
    rng = np.random.default_rng(42)
    cases.append(("pool overflow", 64, 56, None,
                  [(rng.integers(0, 9, 24), None, None, 32)]))
    # a rank-0 row over the probe bound while a later row of its key is
    # placed: all tombstones but a few empty slots, 11 rows of other keys
    # before four rows of key 99 (the layout's seed 2 gives the case)
    rng = np.random.default_rng(2)
    n_empty = int(rng.integers(2, 6))
    tags = np.ones(32, np.uint64)
    tags[rng.permutation(32)[:n_empty]] = 0
    k = np.concatenate([rng.integers(0, 40, 11), [99] * 4]) + 10**6
    cases.append(("rank-0 row over the bound", 32, 0, tags,
                  [(k, None, None, 16)]))
    # invalid rows and retractions in the sentinel segment; the deletes
    # of joinable rows count as inconsistencies
    rng = np.random.default_rng(44)
    ops = rng.choice(np.array([0, 1, 2, 3], np.int8), 96,
                     p=[0.6, 0.15, 0.1, 0.15])
    cases.append(("inactive rows and deletes", 1 << 9, 0, None,
                  [(rng.integers(0, 20, 96), ops, rng.random(96) < 0.8,
                    128)]))
    return cases


def k13_chunk_arrays(k) -> list:
    """A K13 case chunk's columns: the key, window 0 and a name."""
    import numpy as np

    return [np.asarray(k, np.int64), np.zeros(len(k), np.int64),
            np.array([f"n{x % 97}" for x in k], object)]


def _pair_tags(hashes, ranks) -> "np.ndarray":
    """The ``(hash, rank)`` pair tags (the port's ``pair_tag``, the
    reference's bit for bit) as int64 bit patterns."""
    import numpy as np
    import torch

    from risingwave_tpu_torch.state.tag_table import pair_tag

    return pair_tag(torch.from_numpy(np.asarray(hashes, np.int64)),
                    torch.from_numpy(np.asarray(ranks, np.int32))).numpy()


def _hashes_homed(size: int, homes, rng) -> "np.ndarray":
    """One key hash for each wanted home slot of its head ``(hash, 0)``."""
    import numpy as np

    cand = rng.integers(-2**62, 2**62, 16 * size)
    hs = _pair_tags(cand, np.zeros(len(cand), np.int32)) & (size - 1)
    out = []
    for want in homes:
        out.append(int(cand[(hs == want) & ~np.isin(cand, out)][0]))
    return np.array(out, np.int64)


def _place_pairs(tags, degree, hashes, degrees) -> None:
    """In place: each key's entries ``(hash, 0 .. d - 1)`` into the first
    empty slot of their chains (tombstones skipped), ``degree`` at its head
    (a key of degree 0 gets a head only)."""
    import numpy as np

    size = len(tags)
    n = [max(int(d), 1) for d in degrees]
    hs = np.repeat(np.asarray(hashes, np.int64), n)
    ranks = np.concatenate([np.arange(k, dtype=np.int32) for k in n])
    ds = np.repeat(np.asarray(degrees, np.int32), n)
    for tg, r, d in zip(_pair_tags(hs, ranks).tolist(), ranks.tolist(),
                        ds.tolist()):
        c = tg & (size - 1)
        while tags[c] != 0:
            c = (c + 1) & (size - 1)
        tags[c] = tg
        if r == 0:
            degree[c] = d


def k12_ranks(hashes, valid) -> "np.ndarray":
    """Each valid row's rank among the valid rows of its hash, in row order
    (the join's ``_rank_by``)."""
    import torch

    from risingwave_tpu_torch.stream.hash_join import _rank_by

    return _rank_by(torch.from_numpy(hashes),
                    torch.from_numpy(valid)).numpy()


def k12_cases() -> list:
    """K12 ranked's corner cases, shared with
    ``tests/test_torch_ranked_preagg_rounds.py``: ``(name, size, tags,
    degree, calls)``, a table of int64 tag bit patterns and its read-only
    degree array, and calls ``(hashes, chunk_rank, valid)`` that go through
    ``lookup_or_insert_ranked`` one after another on the table."""
    import numpy as np

    cases = []
    # a hot key of pre-chunk degree 40 and 200 rows: its targets run to 239
    rng = np.random.default_rng(121)
    size = 1 << 10
    tags, degree = np.zeros(size, np.int64), np.zeros(size, np.int32)
    hot = rng.integers(-2**62, 2**62)
    others = rng.integers(-2**62, 2**62, 30)
    _place_pairs(tags, degree, [hot], [40])
    _place_pairs(tags, degree, others[:20], rng.integers(1, 4, 20))
    h = np.concatenate([np.full(200, hot), rng.choice(others, 56)])
    h = h[rng.permutation(256)]
    valid = np.ones(256, bool)
    cases.append(("hot key past its degree", size, tags, degree,
                  [(h, k12_ranks(h, valid), valid)]))
    # new keys: a key's rows of rank > 0 meet its head in the round its
    # rank-0 row claims it (they walk the head chain in lock-step); a
    # repeated rank-0 row loses the head to the first and meets it claimed
    # in a later round, reading the degree there (3: it moves to rank 3)
    rng = np.random.default_rng(122)
    size = 1 << 9
    tags, degree = np.zeros(size, np.int64), np.zeros(size, np.int32)
    a, b, c = _hashes_homed(size, [100, 200, 300], rng)
    _place_pairs(tags, degree, rng.integers(-2**62, 2**62, 40),
                 rng.integers(1, 3, 40))
    tags[[100, 101, 200]] = [1, 1, 0]  # a's head chain: two tombstones
    degree[200] = 3
    h = np.array([a, b, a, c, b, a, c, a, b, c], np.int64)
    cr = np.array([0, 0, 1, 0, 0, 2, 1, 3, 1, 2], np.int32)
    cases.append(("head claimed in the call", size, tags, degree,
                  [(h, cr, np.ones(len(h), bool))]))
    # existing keys with degrees 0-5 at their heads (degree 0: the head is
    # the rank-0 target, a stranded entry)
    rng = np.random.default_rng(123)
    size = 1 << 10
    tags, degree = np.zeros(size, np.int64), np.zeros(size, np.int32)
    keys = rng.integers(-2**62, 2**62, 60)
    _place_pairs(tags, degree, keys, rng.integers(0, 6, 60))
    h = rng.choice(keys, 192)
    valid = rng.random(192) < 0.9
    cases.append(("nonzero degree at heads", size, tags, degree,
                  [(h, k12_ranks(h, valid), valid)]))
    # stranded phase-2 entries: ranks past the degree already present
    rng = np.random.default_rng(124)
    size = 1 << 10
    tags, degree = np.zeros(size, np.int64), np.zeros(size, np.int32)
    keys = rng.integers(-2**62, 2**62, 24)
    _place_pairs(tags, degree, keys, np.full(24, 6))
    for i in range(24):  # the degree says 2 of the 6 entries
        head = np.flatnonzero(tags == _pair_tags([keys[i]], [0])[0])[0]
        degree[head] = 2
    h = np.repeat(keys, 6)[rng.permutation(144)]
    valid = np.ones(144, bool)
    cases.append(("stranded entries", size, tags, degree,
                  [(h, k12_ranks(h, valid), valid)]))
    # tombstones through the chains: a run of 40 slots, every other one
    # tombstoned, the others holding keys homed in the run
    rng = np.random.default_rng(125)
    size = 1 << 8
    tags, degree = np.zeros(size, np.int64), np.zeros(size, np.int32)
    keys = _hashes_homed(size, list(range(64, 84)), rng)
    _place_pairs(tags, degree, keys[::2], rng.integers(1, 3, 10))
    run = np.arange(64, 104)
    tags[run[(tags[run] == 0) & (run % 2 == 1)]] = 1
    h = np.concatenate([rng.choice(keys, 40), rng.choice(keys[:4], 24)])
    valid = rng.random(64) < 0.95
    cases.append(("tombstones in the chains", size, tags, degree,
                  [(h, k12_ranks(h, valid), valid)]))
    # claim-scratch collisions: a 16-row chunk (scratch 64) into 2^12 slots,
    # new keys homed 64 and 128 apart, an existing key whose targets land
    # there too
    rng = np.random.default_rng(126)
    size, cap = 1 << 12, 16
    tags, degree = np.zeros(size, np.int64), np.zeros(size, np.int32)
    x = _hashes_homed(size, [1000, 1064, 1128, 2000, 2064], rng)
    h = np.array([x[1], x[0], x[2], x[3], x[4], x[0], x[1], x[3]] +
                 list(rng.integers(-2**62, 2**62, 8)), np.int64)
    valid = np.ones(cap, bool)
    cases.append(("scratch collisions", size, tags, degree,
                  [(h, k12_ranks(h, valid), valid)]))
    # invalid rows among colliding ones, then an all-invalid chunk
    rng = np.random.default_rng(127)
    size = 1 << 9
    tags, degree = np.zeros(size, np.int64), np.zeros(size, np.int32)
    keys = rng.integers(-2**62, 2**62, 16)
    _place_pairs(tags, degree, keys[:8], rng.integers(1, 4, 8))
    h = rng.choice(keys, 96)
    valid = rng.random(96) < 0.6
    calls = [(h, k12_ranks(h, valid), valid),
             (h, k12_ranks(h, valid), np.zeros(96, bool))]
    cases.append(("invalid rows", size, tags, degree, calls))
    # the round bound: 15 of 16 slots taken, 8 new keys; one claims the last
    # empty slot, the others walk to the bound (iters = 2 * 16 + 4)
    rng = np.random.default_rng(128)
    size = 16
    tags = rng.integers(2, 2**62, size)
    tags[rng.integers(0, size)] = 0
    degree = np.zeros(size, np.int32)
    h = rng.integers(-2**62, 2**62, 8)
    valid = np.ones(8, bool)
    cases.append(("round bound", size, tags, degree,
                  [(h, k12_ranks(h, valid), valid)]))
    # a q8-like chunk: 2048 rows into 2^14 slots holding 3000 keys of degree
    # 1-4, a tenth of the empty slots tombstoned; 40% of the rows on the
    # keys, 40% on new keys with repeats, 20% invalid (over 1024 rows
    # listed: the cooperative grid's rounds by default)
    rng = np.random.default_rng(129)
    size, cap = 1 << 14, 2048
    tags, degree = np.zeros(size, np.int64), np.zeros(size, np.int32)
    keys = rng.integers(-2**62, 2**62, 3000)
    _place_pairs(tags, degree, keys, rng.integers(1, 5, 3000))
    tags[(tags == 0) & (rng.random(size) < 0.1)] = 1
    fresh = rng.integers(-2**62, 2**62, 300)
    h = np.concatenate([rng.choice(keys, 820), rng.choice(fresh, 820),
                        rng.integers(-2**62, 2**62, cap - 1640)])
    h = h[rng.permutation(cap)]
    valid = rng.random(cap) < 0.8
    cases.append(("q8-like chunk", size, tags, degree,
                  [(h, k12_ranks(h, valid), valid)]))
    return cases


def phase_join_update_cases(torch, device) -> str:
    """Every ``k13_cases`` case on the card: the pool side update (K12 and
    K13) against the plain update on the whole side after each chunk, and
    K13's rank launch against the plain rank."""
    import numpy as np

    from risingwave_tpu_torch.common.chunk import Chunk
    from risingwave_tpu_torch.common.hash import hash64_columns
    from risingwave_tpu_torch.common.types import DataType, Field, Schema
    from risingwave_tpu_torch.expr.node import InputRef
    from risingwave_tpu_torch.stream import hash_join as hj

    schema = Schema((Field("k", DataType.INT64),
                     Field("w", DataType.TIMESTAMP),
                     Field("name", DataType.VARCHAR, str_width=8)))
    keys = [InputRef(0), InputRef(1)]
    n_chunks = 0
    for name, pool, pool_len, tags, chunks in k13_cases():
        ex = hj.HashJoinExecutor(schema, schema, keys, keys, out_capacity=16,
                                 join_type="inner", left_storage="pool",
                                 right_storage="pool", left_pool_size=pool,
                                 right_pool_size=pool)
        ex.left_clean = (1, 1000, 1)
        sides = [ex.init_state(device).left for _ in range(2)]
        for sd in sides:
            sd.pool_len.fill_(pool_len)
            if tags is not None:
                sd.table.tags.copy_(torch.from_numpy(tags.view(np.int64)))
        for i, (k, ops, valid, cap) in enumerate(chunks):
            chunk = Chunk.from_numpy(schema, k13_chunk_arrays(k), ops=ops,
                                     capacity=cap, device=device)
            if valid is not None:
                full = np.zeros(cap, bool)
                full[:len(k)] = valid
                chunk = Chunk(chunk.columns, chunk.ops,
                              torch.from_numpy(full).to(device), schema)
            key_cols, null_keys = hj._null_stripped_keys(
                [e.eval(chunk) for e in keys])
            h = hash64_columns(key_cols)
            is_ins = hj.insert_mask(chunk, null_keys)
            tag = f"join_update case {name!r} chunk {i}"
            pairs = []
            if device.type == "cuda":
                rk, rp = hj.join_rank_cuda(h, is_ins), \
                    hj._rank_by_sorted(h, is_ins)
                pairs += [(f"{tag} rank", rk[0], rp[0]),
                          (f"{tag} order", rk[1], rp[1])]
            ik = hj.update_side_pool(sides[0], chunk, ex.left_clean,
                                     key_cols, null_keys, h)[1]
            ip = hj._update_side_pool_plain(sides[1], chunk, ex.left_clean,
                                            key_cols, null_keys, h)[1]
            pairs += [(f"{tag} rounds", ik, ip)]
            pairs += [(nm, a, b) for (nm, a), (_, b) in
                      zip(_side_planes(tag, sides[0]),
                          _side_planes(tag, sides[1]))]
            max_abs_err(torch, pairs)
            n_chunks += 1
    return f"{len(k13_cases())} cases, {n_chunks} chunks"


#: K12 ranked's CUDA function (the walk and the rounds in one cooperative
#: launch), for the profiler's device time of a call
RANKED_KERNELS = ("ranked_insert",)


def _ranked_on(t, path: str, h, cr, degree, valid):
    """``t``'s ranked insert on the listed rounds' ``path`` branch (the CPU
    runs the plain version)."""
    if path == "grid":
        return t._ranked_cuda(h, cr, degree, valid, grid_only=True)
    return t.lookup_or_insert_ranked(h, cr, degree, valid)


def _ranked_pairs(tag, tk, rk, tp, rp) -> list:
    """The ranked insert's seven outputs, ``iters`` and the tags of the
    kernel's table ``tk`` against the plain version's ``tp``."""
    names = ("slots", "target", "head_slot", "inserted", "existed",
             "overflow", "iters")
    return [(f"{tag} {nm}", a, b) for nm, a, b in zip(names, rk[1:],
                                                      rp[1:])] + \
        [(f"{tag} tags", tk.tags, tp.tags)]


def phase_ranked_cases(torch, device) -> str:
    """Every ``k12_cases`` call on the card, kernel against plain version
    (the table after each call included), on the forced grid branch and
    the default one."""
    from risingwave_tpu_torch.state.tag_table import (
        TagTable, ranked_claim_stats)

    n_calls = 0
    took = {"grid": 0, "one block": 0}
    cases = k12_cases()
    for path in ("grid", "default") if device.type == "cuda" \
            else ("default",):
        for name, size, tags, degree, calls in cases:
            tk = TagTable(torch.from_numpy(tags).to(device), size)
            tp = tk.clone()
            deg = torch.from_numpy(degree).to(device)
            for i, (h, cr, valid) in enumerate(calls):
                args = (torch.from_numpy(h).to(device),
                        torch.from_numpy(cr).to(device), deg,
                        torch.from_numpy(valid).to(device))
                rk = _ranked_on(tk, path, *args)
                rp = tp._ranked_plain(*args)
                if device.type == "cuda":
                    n, grid_rounds, block_rounds = ranked_claim_stats(device)
                    if n and path == "grid" and block_rounds:
                        fail(f"ranked: forced grid branch ran "
                             f"{block_rounds} one-block rounds")
                    if n:
                        took["grid" if grid_rounds else "one block"] += 1
                max_abs_err(torch, _ranked_pairs(
                    f"ranked case {name!r} call {i} ({path})", tk, rk, tp,
                    rp))
                n_calls += 1
    return (f"{len(cases)} cases, {n_calls} calls, rounds on the "
            f"grid branch {took['grid']} times and on block 0 alone "
            f"{took['one block']}")

def phase_q8_kernels(torch, device, timer, scale):
    """K12-K15 at q8's main-path shapes: the join state of a q8 engine at
    bench sizes after 10 barriers (two 2^22-slot tag tables at the
    load the main path reaches), the next 8192-row auction chunk of the
    stream through its fragment, and the kernels against their plain
    versions on copies of that state."""
    from risingwave_tpu_torch.common.hash import hash64_columns
    from risingwave_tpu_torch.state.tag_table import TagTable, pair_tag
    from risingwave_tpu_torch.common.tree import tree_map
    from risingwave_tpu_torch.stream import hash_join as hj

    def clone_tree(t):
        return tree_map(torch.clone, t)

    eng = _q8_engine(torch, device, scale, 10)
    job = eng.jobs[0]
    join = job.nodes[2].join
    # the next round's person chunk goes into (a copy of) the person side
    # first, as the scheduler does, so the auction chunk finds its sellers
    js = clone_tree(job.states[2])
    _, pchunk = job.nodes[0].fragment.step(clone_tree(job.states[0]),
                                           job.sources["p"].next_chunk())
    js, _ = join.apply_begin(js, pchunk, "left")
    _, achunk = job.nodes[1].fragment.step(clone_tree(job.states[1]),
                                           job.sources["a"].next_chunk())
    cap = achunk.capacity
    key_cols, null_keys = hj._null_stripped_keys(
        [e.eval(achunk) for e in join.right_keys])
    h = hash64_columns(key_cols)
    is_ins = hj.insert_mask(achunk, null_keys)
    cr, _, _ = hj._rank_by_sorted(h, is_ins)
    right, left = js.right, js.left
    size = right.table.size
    live = int(right.table.count())
    tombs = int(right.table.tombstone_count())
    print(f"[q8 state] after 10 barriers: auction table {live} live + "
          f"{tombs} tombstones of {size}, pool_len {int(right.pool_len)}; "
          f"person table {int(left.table.count())} live", flush=True)
    out = {}

    # -- K12 tag_insert_ranked -------------------------------------------
    from risingwave_tpu_torch.state.tag_table import ranked_claim_stats

    paths = ("grid", "default") if device.type == "cuda" else ("default",)
    pairs = []
    stats = {}
    for path in paths:
        tk, tp = right.table.clone(), right.table.clone()
        rk = _ranked_on(tk, path, h, cr, right.count, is_ins)
        rp = tp._ranked_plain(h, cr, right.count, is_ins)
        if device.type == "cuda":
            stats[path] = ranked_claim_stats(device)
        pairs += _ranked_pairs(f"ranked q8 ({path})", tk, rk, tp, rp)
    err = max_abs_err(torch, pairs)
    cases = phase_ranked_cases(torch, device)
    n_ins, iters = int(rp[4].sum()), int(rp[-1])
    n_it = 20
    clones = [right.table.clone() for _ in range(n_it + 1)]
    ms = timer(lambda i: clones[i].lookup_or_insert_ranked(
        h, cr, right.count, is_ins), n_it)
    split = None
    grid_ms = ms
    if device.type == "cuda":
        gc = [right.table.clone() for _ in range(n_it + 1)]
        grid_ms = timer(lambda i: gc[i]._ranked_cuda(
            h, cr, right.count, is_ins, grid_only=True), n_it)
        sc = [right.table.clone() for _ in range(n_it + 1)]
        split = device_ms_by_kernel(
            torch, device, lambda i: sc[i].lookup_or_insert_ranked(
                h, cr, right.count, is_ins), n_it, RANKED_KERNELS)
    pclones = [right.table.clone() for _ in range(3)]
    plain_ms = timer(lambda i: pclones[i]._ranked_plain(h, cr, right.count,
                                                        is_ins), 2)
    # per row: hash 8, rank 4, valid 1 read; slot, target, head 12 and 3
    # flags written; two table reads (head, target) and one degree read;
    # 8 B per claimed entry
    b = bound(cap * (13 + 15 + 2 * 8 + 4) + n_ins * 8, cap * 2 * 60)
    st = stats.get("default")
    rounds = "" if st is None else (
        f"; {st[0]} rows listed, {st[1]} grid and {st[2]} one-block "
        "rounds")
    by_kernel = "" if split is None else (
        f" (device time of its one launch {split['ranked_insert']:.4f} ms "
        "by the profiler)")
    print(f"[tag_insert_ranked] exact (q8's chunk on the "
          f"{', '.join(paths)} branches, {n_ins} claims, {iters} "
          f"rounds{rounds}; {cases}); kernel {ms:.4f} ms{by_kernel}, the "
          f"grid branch forced {grid_ms:.4f}, plain {plain_ms:.4f} ms, "
          f"bound {b[0]:.5f} ms", flush=True)
    out["tag_insert_ranked"] = kernel_entry(
        "tag_probe.cu", "risingwave_tpu/state/hash_table.py:525", ms,
        plain_ms, b, None, err)
    out["tag_insert_ranked"].update(grid_branch_ms=grid_ms)
    if split is not None:
        out["tag_insert_ranked"].update(device_ms=split["ranked_insert"])
    if st is not None:
        out["tag_insert_ranked"].update(listed=st[0], grid_rounds=st[1],
                                        block_rounds=st[2])

    # -- K12 tag_probe: head lookups and the rehash ----------------------
    zeros = torch.zeros(cap, dtype=torch.int32, device=device)
    joinable = achunk.valid
    lk = left.table.lookup_pair_counted(h, zeros, joinable)
    _, ps, pf, po, _ = left.table._probe_tags_plain(pair_tag(h, zeros),
                                                    joinable, False)
    pairs = [("lookup slots", lk[0], ps), ("lookup found", lk[1], pf),
             ("lookup bound", lk[2], (po & joinable).sum(dtype=torch.int64))]
    n_found = int(pf.sum())
    ms = timer(lambda i: left.table.lookup_pair_counted(h, zeros, joinable),
               200)
    plain_ms = timer(lambda i: left.table._probe_tags_plain(
        pair_tag(h, zeros), joinable, False), 5)
    b = bound(cap * (8 + 4 + 1 + 4 + 2) + cap * 8, cap * 40)
    # the rehash of the auction table with tombstones raised to ~25%
    g = torch.Generator(device="cpu").manual_seed(12)
    tt = right.table.clone()
    empty = (tt.tags == 0).cpu()
    want = max(size // 4 - int(tt.tombstone_count()), 0)
    frac = want / max(int(empty.sum()), 1)
    tt.tags[(empty & (torch.rand(size, generator=g) < frac)).to(device)] = 1
    fresh_k, moved_k = tt.rehashed()
    fresh_p = TagTable.create(size, device)
    _, moved_p, _, _, _ = fresh_p._probe_tags_plain(tt.tags, tt.occupied,
                                                    True)
    pairs += [("rehash tags", fresh_k.tags, fresh_p.tags),
              ("rehash moved", moved_k, moved_p)]
    err = max_abs_err(torch, pairs)
    n_live, n_tomb = int(tt.count()), int(tt.tombstone_count())
    rehash_ms = timer(lambda i: tt.rehashed(), 10)
    rehash_plain_ms = timer(lambda i: TagTable.create(size, device)
                            ._probe_tags_plain(tt.tags, tt.occupied, True),
                            1)
    # read the tags once, write the fresh tags and the moved map
    rb = bound(size * (8 + 8 + 4), n_live * 60)
    print(f"[tag_probe] exact (lookup of {cap} heads, {n_found} found; "
          f"rehash of {n_live} live + {n_tomb} tombstones in {size}); "
          f"lookup kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{b[0]:.5f} ms; rehash kernel {rehash_ms:.4f} ms, plain "
          f"{rehash_plain_ms:.4f} ms, bound {rb[0]:.5f} ms", flush=True)
    out["tag_probe"] = kernel_entry(
        "tag_probe.cu", "risingwave_tpu/state/hash_table.py:450", ms,
        plain_ms, b, None, err)
    out["tag_probe"].update(rehash_ms=rehash_ms,
                            rehash_plain_ms=rehash_plain_ms,
                            rehash_bound_ms=rb[0], rehash_bound_by=rb[1],
                            rehash_replaces="risingwave_tpu/state/"
                                            "hash_table.py:686")

    # -- K13 join_update (with K12, against the plain update) ------------
    sk, sp = clone_tree(right), clone_tree(right)
    clean = join.right_clean
    ik = hj.update_side_pool(sk, achunk, clean, key_cols, null_keys, h)[1]
    ip = hj._update_side_pool_plain(sp, achunk, clean, key_cols, null_keys,
                                    h)[1]
    pairs = [(f"update {nm}", a, b) for (nm, a), (_, b)
             in zip(_side_planes("auction side", sk),
                    _side_planes("auction side", sp))]
    pairs.append(("update rounds", ik, ip))
    err = max_abs_err(torch, pairs)
    cases = phase_join_update_cases(torch, device)
    work = clone_tree(right)
    if device.type == "cuda":
        ranked = hj.join_rank_cuda(h, is_ins)
        probe = work.table.clone().lookup_or_insert_ranked(h, ranked[0],
                                                           work.count, is_ins)
        sort_ms = timer(lambda i: torch.sort(hj._sort_key(h, is_ins),
                                             stable=True), 200)
        sk_, order_ = torch.sort(hj._sort_key(h, is_ins), stable=True)
        rank_ms = timer(lambda i: hj.join_rank_sorted_cuda(sk_, order_), 200)
        upd_ms = timer(lambda i: hj.join_update_cuda(
            work, achunk, clean, key_cols, null_keys, is_ins, ranked,
            probe), 50)
        ms = rank_ms + upd_ms
        jsplit = device_ms_by_kernel(
            torch, device, lambda i: (
                hj.join_rank_sorted_cuda(sk_, order_),
                hj.join_update_cuda(work, achunk, clean, key_cols,
                                    null_keys, is_ins, ranked, probe)),
            50, JOIN_UPDATE_KERNELS)
        full_ms = timer(lambda i: hj.update_side_pool(
            clone_tree(right), achunk, clean, key_cols, null_keys, h), 10)
    else:
        jsplit = None
        sort_ms = ms = full_ms = timer(lambda i: hj.update_side_pool(
            clone_tree(right), achunk, clean, key_cols, null_keys, h), 3)
    plain_ms = timer(lambda i: hj._update_side_pool_plain(
        clone_tree(right), achunk, clean, key_cols, null_keys, h), 2)
    n_cols = 56
    # per row: flags, slots, ranks, head, order, segment start ~30 B read;
    # the row's 56 B of columns read and written; pool_pos 4, slot_clean 8
    b = bound(cap * (30 + 2 * n_cols + 12), cap * 30)
    rank_part = "" if device.type != "cuda" else (
        f": rank {rank_ms:.4f}, update {upd_ms:.4f}")
    if jsplit is not None:
        rank_part += " (device time " + ", ".join(
            f"{k} {v:.4f}" for k, v in jsplit.items()) + ")"
    print(f"[join_update] exact (the whole pool side after the update, "
          f"with K12; {cases}); rank + update kernels {ms:.4f} ms"
          f"{rank_part} (the sort {sort_ms:.4f} ms apart), whole update "
          f"{full_ms:.4f} ms, plain "
          f"update (with plain K12) {plain_ms:.4f} ms, bound {b[0]:.5f} ms",
          flush=True)
    out["join_update"] = kernel_entry(
        "join_update.cu", "risingwave_tpu/stream/hash_join.py:597", ms,
        plain_ms, b, None, err)
    out["join_update"].update(whole_update_ms=full_ms, sort_ms=sort_ms)
    if device.type == "cuda":
        out["join_update"].update(rank_ms=rank_ms, update_ms=upd_ms)
    if jsplit is not None:
        out["join_update"]["device_ms"] = jsplit

    # -- K14 join_emit: window 0 of the auction chunk probing persons ----
    st = js._replace(right=clone_tree(right))
    st, pending = join.apply_begin(st, achunk, "right")
    rows, index = join.build_rows_of(st, "right")
    out_cap = join.out_capacity
    args = (rows, index, pending, 0, out_cap, join._specs["right"])
    ek = hj.emit_window(*args)
    ep = hj.emit_window_plain(*args)
    from risingwave_tpu_torch.stream.materialize import value_leaves
    pairs = []
    for ci, (ca, cb) in enumerate(zip(ek[0], ep[0])):
        for j, ((da, _), (db, _)) in enumerate(zip(value_leaves(ca),
                                                   value_leaves(cb))):
            pairs.append((f"emit column {ci}.{j}", da, db))
    pairs += [("emit ops", ek[1], ep[1]), ("emit valid", ek[2], ep[2]),
              ("emit probe_bound", ek[3], ep[3])]
    err = max_abs_err(torch, pairs)
    total, n_valid = int(pending.total), int(ep[2].sum())
    ms = timer(lambda i: hj.emit_window(*args), 200)
    plain_ms = timer(lambda i: hj.emit_window_plain(*args), 5)
    # a pair reads its build row's tag (8 B) and pool_pos (4 B)
    b = emit_bound(pending, 0, out_cap, ek[0], join._specs["right"], 12)
    print(f"[join_emit] exact (window 0 of {total} outputs, {n_valid} "
          f"valid, person names included); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b[0]:.5f} ms", flush=True)
    out["join_emit"] = kernel_entry(
        "join_emit.cu", "risingwave_tpu/stream/hash_join.py:850", ms,
        plain_ms, b, None, err)

    # -- K15 join_clean: a clean and a compaction over 2^22 --------------
    lag = join.right_clean[1]
    wm = min(int(job.states[0][0].max_ts), int(job.states[1][0].max_ts)) \
        - WM_DELAY_US
    thr = torch.tensor(wm - lag + 2 * Q8_WINDOW_US, dtype=torch.int64,
                       device=device)
    ck, cp = clone_tree(right), clone_tree(right)
    sk_ = hj.clean_pool(ck, thr)
    sp_ = hj.clean_pool_plain(cp, thr)
    pairs = [("clean tags", ck.table.tags, cp.table.tags),
             ("clean count", ck.count, cp.count),
             ("clean stats", sk_, sp_)]
    comp_k = hj.compact_pool(ck)
    comp_p = hj.compact_pool_plain(cp)
    pairs += [(f"compact {nm}", a, b) for (nm, a), (_, b)
              in zip(_side_planes("auction side", comp_k),
                     _side_planes("auction side", comp_p))]
    err = max_abs_err(torch, pairs)
    n_stale = int(sp_[0]) - tombs
    cl = [clone_tree(right) for _ in range(11)]
    ms = timer(lambda i: hj.clean_pool(cl[i], thr), 10)
    plain_ms = timer(lambda i: hj.clean_pool_plain(clone_tree(right), thr),
                     3)
    compact_ms = timer(lambda i: hj.compact_pool(ck), 10)
    compact_plain_ms = timer(lambda i: hj.compact_pool_plain(cp), 3)
    # clean: read tag and window key of every slot, write the stale ones
    b = bound(size * 16 + n_stale * 12, size * 6)
    cb = bound(size * (8 + 4 + 4) + size * 4, size * 10)
    print(f"[join_clean] exact (clean of {n_stale} entries, then compaction "
          f"to {int(comp_p.pool_len)} rows); clean kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b[0]:.5f} ms; compaction (with the "
          f"row permutation) {compact_ms:.4f} ms, plain "
          f"{compact_plain_ms:.4f} ms, bound of its scan {cb[0]:.5f} ms",
          flush=True)
    out["join_clean"] = kernel_entry(
        "join_clean.cu", "risingwave_tpu/stream/hash_join.py:1117", ms,
        plain_ms, b, None, err)
    out["join_clean"].update(compact_ms=compact_ms,
                             compact_plain_ms=compact_plain_ms,
                             compact_bound_ms=cb[0],
                             compact_replaces="risingwave_tpu/stream/"
                                              "hash_join.py:1048")
    del eng, js, st, cl, clones, pclones
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def phase_q8_parity(torch, device) -> None:
    """q8 through the engine on ``device`` and on the CPU (plain
    versions) at 10,000 events/s with small pools (chunk 256, pools
    2^14, emission windows of 64 rows): emission drains, watermark
    cleaning, ``rebuild_pool`` and ``compact_pool`` all run.  Ring rows
    in order and every state tensor must be equal after 12 barriers.
    (At 2 events/s, persons are 25 s apart and no 1-second window holds
    a pair, so q8 would emit nothing.)"""
    from risingwave_tpu_torch.compat import state_mismatches, state_to_numpy
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig

    cfg = PlannerConfig(chunk_capacity=256, join_pool_size=1 << 14,
                        join_out_capacity=64, mv_ring_size=1 << 16)
    engines = []
    for dev in (device, torch.device("cpu")):
        eng = Engine(cfg, device=dev)
        eng.execute(BENCH_SOURCES.replace("'1000000'", "'10000'"))
        eng.execute(QUERY_SQL["q8"])
        eng.tick(barriers=12, chunks_per_barrier=4)
        engines.append(eng)
    rows = [[tuple(v if isinstance(v, (str, bytes)) else _host_value(v)
                   for v in r) for r in e.execute("SELECT * FROM bench_mv")]
            for e in engines]
    if rows[0] != rows[1] or not rows[0]:
        fail("q8 ring rows on the card differ from the CPU plain versions")
    bad = state_mismatches(state_to_numpy(engines[1].jobs[0].states),
                           engines[0].jobs[0].states)
    if bad:
        fail(f"q8 state on the card differs from the CPU: {bad[:5]}")
    fired = engines[0].jobs[0].rehash_fired
    if not (fired.get("rebuild_pool") and fired.get("compact_pool")):
        fail(f"q8 parity run did not exercise the maintenance: {fired}")
    js = engines[0].jobs[0].states[2]
    print(f"[parity] q8 at 10,000 events/s, 12 barriers: {len(rows[0])} ring "
          f"rows in order and all state equal to the CPU plain versions "
          f"({int(js.emit_windows)} emission windows, maintenance fired "
          f"{fired})", flush=True)


def _q8_consumed(eng, cap: int, lanes: int = 1):
    """numpy columns of every person and auction the q8 job consumed,
    regenerated, with the watermark filter's late rows dropped (each
    lane's filter sees its own blocks: block i of a source went to lane
    i % lanes)."""
    import numpy as np

    job = eng.jobs[0]
    out = {}
    for name, cols, table in (("p", PERSON_COLS, "persons"),
                              ("a", (7, 4, 5), "auctions")):
        reader = job.sources[name]
        gen = reader.inner.gen
        parts = {i: [] for i in range(len(cols))}
        keep = []
        lane_max = [None] * lanes
        for i in range(reader.offset // cap):
            c = getattr(gen, f"gen_{table}")(i * cap, cap, cols)
            ts = c.columns[-1].cpu().numpy()
            max_ts = lane_max[i % lanes]
            wm = None if max_ts is None else max_ts - WM_DELAY_US
            keep.append(np.ones(cap, bool) if wm is None else ts >= wm)
            lane_max[i % lanes] = int(ts.max()) if max_ts is None \
                else max(max_ts, int(ts.max()))
            for j, col in enumerate(c.columns):
                if hasattr(col, "lens"):
                    parts[j].append((col.data.cpu().numpy(),
                                     col.lens.cpu().numpy()))
                else:
                    parts[j].append(col.cpu().numpy())
        k = np.concatenate(keep)
        cols_np = []
        for j in range(len(cols)):
            if isinstance(parts[j][0], tuple):
                cols_np.append((np.concatenate([p[0] for p in parts[j]])[k],
                                np.concatenate([p[1] for p in parts[j]])[k]))
            else:
                cols_np.append(np.concatenate(parts[j])[k])
        out[name] = cols_np
    return out


def _name_key(data, lens):
    """An int64 key per fixed-width string (bytes past lens masked)."""
    import numpy as np

    w = data.shape[1]
    masked = np.where(np.arange(w)[None, :] < lens[:, None], data, 0)
    words = np.zeros((data.shape[0], -(-w // 8) * 8), np.uint8)
    words[:, :w] = masked
    k = np.zeros(data.shape[0], np.uint64)
    for j, word in enumerate(words.view(np.uint64).T):
        k = (k * np.uint64(1_000_003)) ^ (word + np.uint64(j))
    return (k ^ lens.astype(np.uint64)).view(np.int64)


def check_q8(eng, cap: int, lanes: int = 1) -> str:
    """The ring (every lane's, for a sharded job) equals a numpy inner
    join of the consumed persons and auctions on p.id = a.seller within
    the same 1-second window, as a multiset of (id, name, reserve)."""
    import numpy as np

    c = _q8_consumed(eng, cap, lanes)
    (pid, (pname, plens), pts), (seller, reserve, ats) = c["p"], c["a"]
    pws = pts - pts % Q8_WINDOW_US
    aws = ats - ats % Q8_WINDOW_US
    base = int(min(pws.min(), aws.min()))
    pkey = pid * (1 << 24) + (pws - base) // Q8_WINDOW_US
    akey = seller * (1 << 24) + (aws - base) // Q8_WINDOW_US
    order = np.argsort(pkey, kind="stable")
    spk = pkey[order]
    if np.any(spk[1:] == spk[:-1]):
        fail("q8 check: a person (id, window) appears twice")
    at = np.searchsorted(spk, akey)
    at_c = np.minimum(at, spk.shape[0] - 1)
    hit = spk[at_c] == akey
    prow = order[at_c[hit]]
    want = np.stack([pid[prow], _name_key(pname[prow], plens[prow]),
                     reserve[hit]], 1)
    got = q8_ring_rows(eng, lanes)
    n = got.shape[0]
    if n != want.shape[0]:
        fail(f"q8 ring holds {n} rows for {want.shape[0]} numpy join rows")
    want = want[np.lexsort(want.T[::-1])]
    if not np.array_equal(got, want):
        fail("q8 ring rows differ from the numpy join (as multisets)")
    return (f"ring rows equal the numpy join of {pid.shape[0]} persons and "
            f"{seller.shape[0]} auctions ({n} rows over {lanes} lane(s), no "
            "lap)")


def q8_ring_rows(eng, lanes: int = 1):
    """The q8 ring's rows of every lane as a sorted numpy ``[n, 3]``
    array of (id, name key, reserve); fails on an overflow or a lap."""
    import numpy as np

    entry = eng.catalog.get("bench_mv")
    state = eng.jobs[0].states[entry.mv_state_index[0]][
        entry.mv_state_index[1]]
    cursors = state.cursor.reshape(-1).tolist()
    overflow = int(state.overflow.sum())
    if overflow != 0 or max(cursors) > entry.mv_executor.ring_size:
        fail(f"q8 ring holds {cursors} rows, overflow {overflow}")
    ids, names, res = state.values
    if lanes == 1:
        ids, data, lens, res = (x[None] for x in (ids, names.data,
                                                  names.lens, res))
    else:
        data, lens = names.data, names.lens
    got = np.concatenate([np.stack([
        ids[s, :k].cpu().numpy(),
        _name_key(data[s, :k].cpu().numpy(), lens[s, :k].cpu().numpy()),
        res[s, :k].cpu().numpy()], 1) for s, k in enumerate(cursors)])
    return got[np.lexsort(got.T[::-1])]


def phase_q8_main_path(torch, device, scale):
    """q8 at bench.py's sizes: 9 warm-up barriers, then 32 timed barriers
    of 8 scheduling rounds (1 person + 3 auction chunks each), with the
    launch counters, the host reads and the maintenance counts taken
    over the timed window."""
    from risingwave_tpu_torch import kernels

    eng = _q8_engine(torch, device, scale,
                     WARMUP_BARRIERS if device.type == "cuda" else 1)
    job = eng.jobs[0]
    if device.type == "cuda":
        torch.cuda.synchronize()
    kernels.reset_launches()
    reads0 = (job.window_reads, job.barrier_reads)
    fired0 = dict(job.rehash_fired)
    rows0 = eng.metrics.get("stream_rows_total", job="bench_mv")
    barriers = BARRIERS if device.type == "cuda" else 2
    t0 = time.perf_counter()
    eng.tick(barriers=barriers, chunks_per_barrier=CHUNKS_PER_BARRIER)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    cap = job.sources["p"].cap
    chunks = barriers * CHUNKS_PER_BARRIER * 4
    rows = chunks * cap
    counted = eng.metrics.get("stream_rows_total", job="bench_mv") - rows0
    if counted != rows:
        fail(f"q8 counted {counted} rows, expected {rows}")
    reads = (job.window_reads - reads0[0], job.barrier_reads - reads0[1])
    fired = {k: v - fired0.get(k, 0) for k, v in job.rehash_fired.items()}
    rate = rows / dt
    print(f"[main] q8 {rows} rows (persons and auctions) in {dt:.3f} s = "
          f"{rate:.0f} rows/s; host reads: {reads[0]} emission totals + "
          f"{reads[1]} barrier condition reads = {sum(reads) / chunks:.3f} "
          f"per chunk; rebuild_pool x{fired.get('rebuild_pool', 0)}, "
          f"compact_pool x{fired.get('compact_pool', 0)} in the window; "
          f"port kernel launches {launches}", flush=True)
    if device.type == "cuda":
        per_chunk = profile_window(torch, eng, "q8", barriers=1,
                                   chunks_per_barrier=4 * CHUNKS_PER_BARRIER)
        print(f"[main] q8 launches per chunk "
              f"{'not measured' if per_chunk is None else f'{per_chunk:.1f}'}"
              f" (all CUDA kernels, profiled window)", flush=True)
    eng.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1")
    eng.tick(barriers=1, chunks_per_barrier=0)
    print(f"[check] q8 {check_q8(eng, cap)}", flush=True)
    del eng
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return launches, rate


# ---------------------------------------------------------------------------
# K11 and K4 at q8's bench-size state


def phase_state_kernels(torch, device, timer, scale):
    """K11 (the shadow update and the delta's dirty gather) and K4 (the
    row permutation) on the state tree of a bench-size q8 engine after
    its warm-up: the init, two more barriers of traffic, the update at
    the dirty share they leave, the gather of those blocks, and K4 at
    ``rebuild_pool``'s and ``compact_pool``'s shapes, each against its
    plain version."""
    import numpy as np

    from risingwave_tpu_torch.common.tree import flatten
    from risingwave_tpu_torch.state.hash_table import (
        _col_leaves,
        permute_dense_many,
        permute_rows,
        permute_rows_plain,
    )
    from risingwave_tpu_torch.storage import digest as dg

    eng = _q8_engine(torch, device, scale,
                     WARMUP_BARRIERS if device.type == "cuda" else 1)
    job = eng.jobs[0]
    block = dg.DEFAULT_BLOCK_ELEMS

    def flat_leaves():
        return [x.reshape(-1) for x in flatten(job.states)[0]]

    leaves = flat_leaves()
    nblocks = [dg.leaf_block_count(x.shape, block) for x in leaves]
    total = sum(nblocks)
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    words = sum(nb * block * x.element_size() // 8
                for x, nb in zip(leaves, nblocks))

    def buffers():
        return ([torch.empty_like(x) for x in leaves],
                torch.zeros(total, dtype=torch.int64, device=device),
                torch.zeros((), dtype=torch.int64, device=device))

    shk, dgk, dck = buffers()
    shp, dgp, dcp = buffers()
    dg.shadow_digest(leaves, shk, dgk, dck, nblocks, block, update=False)
    dg.shadow_digest_plain(leaves, shp, dgp, dcp, nblocks, block,
                           update=False)
    pairs = [("init digests", dgk, dgp)]
    pairs += [(f"init shadow leaf {i}", a, b)
              for i, (a, b) in enumerate(zip(shk, shp))]
    max_abs_err(torch, pairs)
    init_ms = timer(lambda i: dg.shadow_digest(
        leaves, shk, dgk, dck, nblocks, block, update=False), 5)
    init_plain_ms = timer(lambda i: dg.shadow_digest_plain(
        leaves, shp, dgp, dcp, nblocks, block, update=False), 1)
    copy_ms = timer(lambda i: [a.copy_(b) for a, b in zip(shp, leaves)], 5)

    # two barriers of traffic, then the update
    eng.tick(barriers=2, chunks_per_barrier=CHUNKS_PER_BARRIER)
    leaves = flat_leaves()
    old = dgk.clone()
    dg.shadow_digest(leaves, shk, dgk, dck, nblocks, block, update=True)
    dg.shadow_digest_plain(leaves, shp, dgp, dcp, nblocks, block,
                           update=True)
    pairs = [("update digests", dgk, dgp), ("update dirty", dck, dcp)]
    pairs += [(f"update shadow leaf {i}", a, b)
              for i, (a, b) in enumerate(zip(shk, shp))]
    pairs += [(f"shadow equals live leaf {i}", a, b)
              for i, (a, b) in enumerate(zip(shk, leaves))]
    err = max_abs_err(torch, pairs)
    dirty = (dgk != old).cpu().numpy()
    n_dirty, ladder_dirty = int(dirty.sum()), int(dck)
    dirty_bytes = sum(
        int(dirty[o:o + nb].sum()) * block * x.element_size()
        for x, nb, o in zip(leaves, nblocks,
                            np.cumsum([0] + nblocks[:-1])))

    def update(i):
        dgk.copy_(old)  # every call diffs against the same old digests
        dg.shadow_digest(leaves, shk, dgk, dck, nblocks, block, update=True)

    ms = timer(update, 10)

    def update_plain(i):
        dgp.copy_(old)
        dg.shadow_digest_plain(leaves, shp, dgp, dcp, nblocks, block,
                               update=True)

    plain_ms = timer(update_plain, 1)
    # read every live byte once, write the dirty blocks and the digests;
    # per 8-byte word ~3 64-bit multiplies (~4 32-bit ops each) and ~9
    # other ops
    b = bound(nbytes + dirty_bytes + 16 * total, words * 21)
    print(f"[shadow_digest] exact (q8 state: {len(leaves)} leaves, "
          f"{nbytes / 1e6:.1f} MB, {total} blocks; after 2 barriers "
          f"{n_dirty} blocks dirty ({100 * n_dirty / total:.1f}%), "
          f"{ladder_dirty} counted); update kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b[0]:.5f} ms ({b[1]}); init kernel "
          f"{init_ms:.4f} ms, plain {init_plain_ms:.4f} ms; store-less "
          f"copy_ of the tree {copy_ms:.4f} ms", flush=True)
    out = {"shadow_digest": kernel_entry(
        "shadow_digest.cu", "risingwave_tpu/stream/shadow.py:214", ms,
        plain_ms, b, None, err)}
    out["shadow_digest"].update(
        init_ms=init_ms, init_plain_ms=init_plain_ms,
        storeless_copy_ms=copy_ms, state_bytes=nbytes, blocks=total,
        dirty_blocks=n_dirty)

    # -- the delta's dirty gather ----------------------------------------
    sizes = [x.numel() for x in leaves]
    esizes = [x.element_size() for x in leaves]
    entries, runs, gtotal = dg.gather_plan(dirty, nblocks, sizes, esizes,
                                           block)
    ent = torch.from_numpy(entries).to(device)
    stk = torch.zeros(gtotal, dtype=torch.uint8, device=device)
    stp = torch.zeros(gtotal, dtype=torch.uint8, device=device)
    dg.dirty_gather(shk, ent, stk, nblocks, block)
    dg.dirty_gather_plain(shk, ent, stp, block)
    pairs = [("gather staging", stk, stp)]
    # the runs cut from it are the shadow's flat slices
    host = stk.cpu().numpy()
    for li, s0, e0, o in runs[:64] + runs[-64:]:
        x = shk[li]
        want = x[s0:e0].cpu().numpy().view(np.uint8)
        if not np.array_equal(host[o:o + want.size], want):
            fail(f"gather run r_{li}_{s0} differs from the shadow slice")
    err = max_abs_err(torch, pairs)
    gms = timer(lambda i: dg.dirty_gather(shk, ent, stk, nblocks, block), 20)
    gplain_ms = timer(lambda i: dg.dirty_gather_plain(shk, ent, stp, block),
                      2)
    gb = bound(2 * gtotal + entries.nbytes, len(entries) * 8)
    # the library yardstick: no single PyTorch call computes the gather
    # (it spans every leaf, pads each block to 16 bytes and cuts the tail
    # blocks); one torch.index_select over the block view of the leaf
    # with the most dirty full blocks computes that leaf's share
    e_leaf = entries[:, 0] >> 32
    e_blk = entries[:, 0] & 0xFFFFFFFF
    full = np.array([(int(b) + 1) * block <= sizes[int(li)]
                     for li, b in zip(e_leaf, e_blk)], bool)
    li = int(np.bincount(e_leaf[full], minlength=len(leaves)).argmax())
    sel = full & (e_leaf == li)
    x = shk[li].reshape(-1)
    nbf = x.numel() // block
    view = x[:nbf * block].view(nbf, block)
    idx = torch.from_numpy(e_blk[sel].astype(np.int64)).to(device)
    if not sel.any():
        fail("no leaf has a dirty full block to time index_select on")
    if not torch.equal(torch.index_select(view, 0, idx).reshape(-1).view(
            torch.uint8), stk[int(entries[sel][0, 1]):int(entries[sel][0, 1])
                              + int(sel.sum()) * block * x.element_size()]):
        fail("index_select over the leaf's block view differs from the "
             "gather's section of it")
    lib_ms = timer(lambda i: torch.index_select(view, 0, idx), 20)
    print(f"[dirty_gather] exact ({len(entries)} blocks in {len(runs)} "
          f"runs, {gtotal / 1e6:.1f} MB); kernel {gms:.4f} ms, plain "
          f"{gplain_ms:.4f} ms, bound {gb[0]:.5f} ms; one index_select "
          f"over leaf {li}'s block view ({int(sel.sum())} of the "
          f"{len(entries)} blocks, equal to the gather's section) "
          f"{lib_ms:.4f} ms", flush=True)
    out["dirty_gather"] = kernel_entry(
        "shadow_digest.cu", "risingwave_tpu/storage/checkpoint_store.py:249",
        gms, gplain_ms, gb, None, err)
    out["dirty_gather"]["index_select_one_leaf"] = {
        "ms": lib_ms, "blocks": int(sel.sum()), "of": len(entries)}
    del shk, shp, stk, stp

    # -- K4: rebuild_pool's and compact_pool's row permutations ----------
    right, left = job.states[2].right, job.states[2].left
    _, moved = right.table.rehashed()
    cols = [right.count, right.pool_pos, right.slot_clean]
    inits = [None, 5, -(1 << 40)]
    pk = permute_rows(cols, moved, inits)
    pp = [permute_rows_plain(c, moved, i) for c, i in zip(cols, inits)]
    pairs = [(f"rebuild column {i}", a, b)
             for i, (a, b) in enumerate(zip(pk, pp))]

    def compaction_map(side):
        occ = side.table.occupied
        pos = side.pool_pos[occ].to(torch.int64)
        pool = side.rows[0].shape[0]
        m = torch.full((pool,), pool, dtype=torch.int32, device=device)
        m[pos] = torch.arange(pos.numel(), dtype=torch.int32,
                              device=device)
        return m, pos.numel()

    moved_r, live_r = compaction_map(right)
    moved_l, live_l = compaction_map(left)
    for tag, side, m in (("auction", right, moved_r),
                         ("person", left, moved_l)):
        got = permute_dense_many(side.rows, m)
        flat_in = [t for r in side.rows for t, _ in _col_leaves(r, None)]
        flat_got = [t for r in got for t, _ in _col_leaves(r, None)]
        pairs += [(f"compact {tag} column {i}", a,
                   permute_rows_plain(c, m))
                  for i, (a, c) in enumerate(zip(flat_got, flat_in))]
    err = max_abs_err(torch, pairs)
    rows_r = [t for r in right.rows for t, _ in _col_leaves(r, None)]
    row_bytes = sum(t[0].numel() * t.element_size() for t in rows_r)
    pool = rows_r[0].shape[0]
    ms = timer(lambda i: permute_dense_many(right.rows, moved_r), 20)
    plain_ms = timer(lambda i: [permute_rows_plain(c, moved_r)
                                for c in rows_r], 3)
    tgt = moved_r.to(torch.int64)
    dumps = [torch.zeros((pool + 1,) + c.shape[1:], dtype=c.dtype,
                         device=device) for c in rows_r]
    lib_ms = timer(lambda i: [o.index_put_((tgt,), c)
                              for o, c in zip(dumps, rows_r)], 20)
    rebuild_ms = timer(lambda i: permute_rows(cols, moved, inits), 20)
    rebuild_plain_ms = timer(lambda i: [permute_rows_plain(c, moved, i_)
                                        for c, i_ in zip(cols, inits)], 3)
    size = moved.shape[0]
    live_slots = int((moved < size).sum())
    # the live rows read, every output row written, and `moved` read
    b = bound((live_r + pool) * row_bytes + 4 * pool, pool * len(rows_r))
    rb = bound((live_slots + size) * (4 + 4 + 8) + 4 * size, size * 3)
    print(f"[permute_rows] exact (compaction of the auction pool, "
          f"{live_r} of {pool} rows live, {len(rows_r)} columns, "
          f"{row_bytes} B a row; the person pool's, {live_l} live, name "
          f"strings included; rebuild_pool's 3 columns over {size} slots, "
          f"init set and unset); compaction kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, index_put_ per column {lib_ms:.4f} ms, "
          f"bound {b[0]:.5f} ms; rebuild kernel {rebuild_ms:.4f} ms, "
          f"plain {rebuild_plain_ms:.4f} ms, bound {rb[0]:.5f} ms",
          flush=True)
    out["permute_rows"] = kernel_entry(
        "permute.cu", "risingwave_tpu/state/hash_table.py:115", ms,
        plain_ms, b, lib_ms, err)
    out["permute_rows"].update(rebuild_ms=rebuild_ms,
                               rebuild_plain_ms=rebuild_plain_ms,
                               rebuild_bound_ms=rb[0])
    del eng, dumps
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the durable main path and the cold start


def _durable_config(query: str, scale: int) -> dict:
    if query in TOPN_QUERIES:
        return _topn_config(scale)
    if query == "q8":
        cfg = {k: max(v // scale, 64) for k, v in Q8_CONFIG.items()}
        if scale > 1:  # the rehearsal's pools hold every row of its run
            cfg.update(join_pool_size=1 << 17, mv_ring_size=1 << 19)
        return cfg
    cfg = {k: v // scale for k, v in BENCH_CONFIG.items()}
    cfg["mv_ring_size"] = (1 << 21) // scale
    return cfg


def _durable_engine(torch, device, cfg, data_dir):
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig

    return Engine(PlannerConfig(**cfg), data_dir=data_dir, device=device)


def phase_durable(torch, device, scale, query: str, storeless_rate):
    """``Engine(config, data_dir=...)`` at bench.py's sizes: 9 warm-up and
    32 timed barriers with a snapshot every 8 checkpoints (K11 and the
    background uploader), then a cold start from the directory, 8 more
    barriers, and every state tensor (q7's MV, q8's ring in order)
    against one store-less engine that ran the same barriers without
    stopping."""
    import gc
    import shutil
    import tempfile

    from risingwave_tpu_torch import kernels
    from risingwave_tpu_torch.common.tree import flatten
    from risingwave_tpu_torch.stream.shadow import ShadowSnapshot

    cfg = _durable_config(query, scale)
    # the CPU rehearsal times a quarter of the barriers (one snapshot)
    # of a quarter of the chunks
    timed = BARRIERS if device.type == "cuda" else BARRIERS // 4
    per = CHUNKS_PER_BARRIER if device.type == "cuda" \
        else CHUNKS_PER_BARRIER // 4
    data_dir = tempfile.mkdtemp(prefix=f"rw_durable_{query}_")
    ddl = [BENCH_SOURCES, QUERY_SQL[query],
           "ALTER SYSTEM SET maintenance_interval_checkpoints = 1000000",
           "ALTER SYSTEM SET snapshot_interval_checkpoints = 8"]
    try:
        eng = _durable_engine(torch, device, cfg, data_dir)
        for sql in ddl:
            eng.execute(sql)
        eng.tick(barriers=WARMUP_BARRIERS,
                 chunks_per_barrier=per)
        job, store = eng.jobs[0], eng.checkpoint_store
        if device.type == "cuda":
            torch.cuda.synchronize()
        kernels.reset_launches()
        ShadowSnapshot.timing = []
        n_commits = len(store.commits)
        stall0, up0 = job.stall_seconds, job._uploader.upload_seconds_total
        t0 = time.perf_counter()
        eng.tick(barriers=timed, chunks_per_barrier=per)
        if device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        snaps = ShadowSnapshot.timing
        ShadowSnapshot.timing = None
        snap_ms = [ev[0].elapsed_time(ev[1]) for ev in snaps
                   if ev is not None]
        commits = list(store.commits)[n_commits:]
        rounds = 4 if query == "q8" else 1
        chunks = timed * per * rounds
        rows = chunks * cfg["chunk_capacity"]
        rate = rows / dt
        port = sum(launches.values())
        print(f"[durable] {query} {rows} rows in {dt:.3f} s = {rate:.0f} "
              f"rows/s (store-less run of this process: "
              f"{storeless_rate:.0f} rows/s); snapshots sealed "
              f"{len(snaps)}, committed {len(commits)} (committed epoch "
              f"{job.committed_epoch} = sealed {job.sealed_epoch}); "
              f"uploader stall {job.stall_seconds - stall0:.3f} s, upload "
              f"work {job._uploader.upload_seconds_total - up0:.3f} s; "
              f"port kernel launches {port / chunks:.1f} per chunk "
              f"{launches}", flush=True)
        for (_, epoch, kind, nbytes, nd, nb) in commits:
            print(f"[durable] {query} epoch {epoch}: {kind}, {nbytes} B, "
                  f"{nd} of {nb} blocks dirty ({100 * nd / max(nb, 1):.1f}%)",
                  flush=True)
        if snap_ms:
            print(f"[durable] {query} K11 device time per snapshot "
                  f"{', '.join(f'{m:.4f}' for m in snap_ms)} ms", flush=True)
        if job.committed_epoch != job.sealed_epoch or len(commits) != \
                len(snaps):
            fail(f"{query}: {len(snaps)} sealed, {len(commits)} committed")
        sealed = (WARMUP_BARRIERS + timed) // 8 * 8
        del eng, job
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

        # -- the cold start --------------------------------------------
        t0 = time.perf_counter()
        eng = _durable_engine(torch, device, cfg, data_dir)
        if device.type == "cuda":
            torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
        eng.tick(barriers=8, chunks_per_barrier=per)
        whole = _durable_engine(torch, device, cfg, None)
        for sql in ddl:
            whole.execute(sql)
        whole.tick(barriers=sealed + 8, chunks_per_barrier=per)
        la = flatten(eng.jobs[0].states)[0]
        lb = flatten(whole.jobs[0].states)[0]
        max_abs_err(torch, [(f"cold start leaf {i}", a, b)
                            for i, (a, b) in enumerate(zip(la, lb))])
        what = "ring rows in order" if query == "q8" else "MV rows"
        if query != "q8":
            ra = sorted(eng.execute("SELECT * FROM bench_mv"))
            if ra != sorted(whole.execute("SELECT * FROM bench_mv")):
                fail(f"{query}: MV rows differ after the cold start")
        print(f"[cold start] {query} recovered the epoch of barrier "
              f"{sealed} in {rec_s:.3f} s (DDL replay, load, upload to the "
              f"device); after 8 more barriers every state tensor ({what} "
              f"included) equals an engine that ran {sealed + 8} barriers "
              f"without stopping", flush=True)
        del eng, whole
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return launches, rate, {"sealed": len(snaps),
                                "snapshot_ms": snap_ms,
                                "recover_s": rec_s}
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# q19 and q18: group top-N through the ROW_NUMBER rewrite


#: bench.py's PlannerConfig with the slice's top-N sizes: a pool of 2^18
#: rows (the band plus a barrier of inserts), an emitted band of 2^16 and
#: an MV table of 2^18 (the band of 41 barriers of q18 is ~53,000 rows)
TOPN_CONFIG = dict(BENCH_CONFIG, topn_pool_size=1 << 18,
                   topn_emit_capacity=1 << 16, mv_table_size=1 << 18)
#: the CPU rehearsal's sizes (its band is a larger share of its bids)
TOPN_REHEARSAL = dict(chunk_capacity=128, topn_pool_size=1 << 15,
                      topn_emit_capacity=1 << 13, mv_table_size=1 << 15)
TOPN_QUERIES = ("q19", "q18")
#: queue pre-fill per call for the top-N wrappers and plain versions,
#: which enqueue tens of PyTorch launches a call
TOPN_PREFILL_MS = 4.0
#: a bid's payload bytes (4 int64, 16 + 40 string bytes and 2 lengths)
BID_ROW_BYTES = 4 * 8 + 16 + 40 + 2 * 4


def _topn_config(scale: int) -> dict:
    return dict(TOPN_CONFIG) if scale == 1 else dict(TOPN_REHEARSAL)


def _topn_engine(torch, device, scale, query: str, barriers: int):
    """A q19 or q18 engine at the slice's sizes after ``barriers``
    barriers (maintenance off, a snapshot every 8 checkpoints)."""
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig

    eng = Engine(PlannerConfig(**_topn_config(scale)), device=device)
    eng.execute(BENCH_SOURCES)
    eng.execute(QUERY_SQL[query])
    eng.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1000000")
    eng.execute("ALTER SYSTEM SET snapshot_interval_checkpoints = 8")
    eng.tick(barriers=barriers, chunks_per_barrier=CHUNKS_PER_BARRIER)
    return eng


def _topn_index(eng) -> int:
    return _executor_index(eng, "GroupTopNExecutor")


def _topn_planes(tag, st):
    """Every tensor of a TopNState, flattened with names."""
    from risingwave_tpu_torch.common.tree import flatten

    leaves = flatten(st)[0]
    return [(f"{tag} leaf {i}", x) for i, x in enumerate(leaves)]


def _topn_inputs(torch, eng, n: int):
    """The TopN's next ``n`` input chunks: source chunks through the
    executors before it, on a copy of their state."""
    from risingwave_tpu_torch.common.tree import tree_map

    job = eng.jobs[0]
    ti = _topn_index(eng)
    states = list(tree_map(torch.clone, job.states))
    out = []
    for _ in range(n):
        cur = job.source.next_chunk()
        for i in range(ti):
            states[i], cur = job.fragment.executors[i].apply(states[i], cur)
        out.append(cur)
    return out


def _retractable_chunk(torch, st, cap, g, schema):
    """``cap`` rows against a pool: deletes of valid pool rows (some
    twice), in-chunk +/- pairs, duplicate inserts, deletes of rows the
    pool lacks and fresh inserts, as a changelog chunk."""
    from risingwave_tpu_torch.common.chunk import Chunk
    from risingwave_tpu_torch.stream.top_n import _gather

    dev = st.valid.device
    live = torch.nonzero(st.valid).flatten().cpu()
    pick = live[torch.randint(0, live.numel(), (cap,), generator=g)]
    pick[1::16] = pick[0::16]                          # duplicate deletes
    idx = pick.to(dev)
    cols = [_gather(c, idx) for c in st.rows]
    ops = torch.ones(cap, dtype=torch.int8)            # Delete
    kind = torch.randint(0, 8, (cap,), generator=g)
    ops[kind == 1] = 2                                 # UpdateDelete
    ops[kind >= 3] = 0                                 # re-inserts / dups
    ops[kind == 7] = 3                                 # UpdateInsert
    ops[2::32] = 0                                     # +/- pairs with the
    ops[3::32] = 1                                     # row before
    rows = torch.arange(cap)
    src = torch.where(torch.arange(cap) % 32 == 3, rows - 1, rows).to(dev)
    cols = [_gather(c, src) for c in cols]
    # a few rows the pool never held: deletes that find nothing
    miss = torch.arange(cap, device=dev) % 97 == 5
    cols[0] = torch.where(miss, cols[0] + (1 << 40), cols[0])
    valid = torch.rand(cap, generator=g) < 0.97
    return Chunk(tuple(cols), ops.to(dev), valid.to(dev), schema)


#: the K16 cases' pool rows: two int64 columns, a 12-byte string (4-byte
#: words) and a timestamp
K16_FIELDS = (("a", "INT64", 0), ("b", "INT64", 0), ("s", "VARCHAR", 12),
              ("t", "TIMESTAMP", 0))
K16_INS, K16_DEL = 0, 1  # Insert, Delete (the ops 3 and 2 follow them)


def _k16_rows(rng, n: int) -> list:
    """``n`` distinct rows of ``K16_FIELDS`` (numpy columns; random bytes
    past the strings' lengths)."""
    import numpy as np

    w = K16_FIELDS[2][2]
    return [rng.integers(0, 6, n).astype(np.int64),
            rng.permutation(n).astype(np.int64) * 7919 - 10**6,
            (rng.integers(0, 256, (n, w)).astype(np.uint8),
             rng.integers(0, w + 1, n).astype(np.int32)),
            rng.integers(0, 50, n).astype(np.int64)]


def k16_cases() -> list:
    """K16's corner cases, shared with
    ``tests/test_torch_ring_pool_grid.py``: dicts with the pool size
    ``S``, the chunk capacity ``cap``, ``rows`` (distinct rows as
    ``_k16_rows`` makes them) and ``chunks``, a script applied in turn to
    an empty pool: each (row index [cap], op int8 [cap], valid [cap]).
    Deletes are op 1 or 2, inserts 0 or 3.  The kernel runs 512 threads a
    block: the wide case's contested and candidate lists take two tiles."""
    import numpy as np

    rng = np.random.default_rng(16)
    rows = _k16_rows(rng, 4096)
    out = []

    def chunk(cap, idx, ops, valid=None):
        """A chunk of ``cap`` rows: the listed ones first (visible unless
        ``valid`` says otherwise), then invisible rows."""
        idx, ops = np.asarray(idx, np.int64), np.asarray(ops, np.int8)
        n = idx.shape[0]
        pad = cap - n
        v = np.ones(n, bool) if valid is None else np.asarray(valid, bool)
        return (np.concatenate([idx, rng.integers(0, 4096, pad)]),
                np.concatenate([ops, rng.choice([0, 1, 2, 3], pad)
                                .astype(np.int8)]),
                np.concatenate([v, np.zeros(pad, bool)]))

    def ins(idx):
        return list(idx), [rng.choice([0, 3]) for _ in idx]

    def case(name, S, cap, chunks):
        out.append(dict(name=name, S=S, cap=cap, rows=rows, chunks=chunks))

    # an append-only chunk into a pool whose free slots are scattered
    dels = rng.choice(128, 25, replace=False)
    case("scattered_free", 256, 64, [
        chunk(64, *ins(range(64))), chunk(64, *ins(range(64, 128))),
        chunk(64, dels, rng.choice([1, 2], 25)),
        chunk(64, *ins(range(128, 192))), chunk(64, *ins(range(192, 256)))])
    # more inserts than free slots
    case("overflow", 96, 64, [
        chunk(64, *ins(range(64))), chunk(64, *ins(range(64, 128))),
        chunk(64, *ins(range(128, 192)))])
    # annihilation: a +/- pair (50); row 40 with 3 deletes and 1 insert
    # against 2 pool copies; row 41 with 3 inserts and 1 delete; row 5
    # deleted; two fresh inserts
    idx = [50, 50, 40, 40, 40, 40, 41, 41, 41, 41, 5, 60, 61]
    ops = [0, 1, 1, 2, 1, 0, 0, 3, 1, 0, 1, 0, 3]
    order = rng.permutation(len(idx))
    case("annihilation", 256, 64, [
        chunk(64, *ins(list(range(32)) + [40, 40])),
        chunk(64, np.asarray(idx)[order], np.asarray(ops)[order])])
    # duplicates: five copies of row 7; a delete frees slot 1, a sixth copy
    # takes it (newest, but first in slot order); two deletes clear the
    # first two copies in slot order
    first = [0, 1, 2, 7, 3, 4, 5, 6, 7, 8, 9, 7, 10, 7, 11, 7]
    case("duplicates", 256, 64, [
        chunk(64, *ins(first)), chunk(64, [1], [1]), chunk(64, [7], [0]),
        chunk(64, [7, 9, 7], [2, 1, 1])])
    # deletes that miss: rows never inserted, and row 5 twice (one copy)
    case("missing", 256, 64, [
        chunk(64, *ins(range(20))),
        chunk(64, list(range(100, 111)) + [5, 5], [1] * 11 + [2, 1])])
    # inserts that take the slots deletes freed in the same call
    case("reuse", 64, 64, [
        chunk(64, *ins(range(64))),
        chunk(64, [70, 10, 71, 20, 72], [0, 1, 3, 2, 0])])
    # an all-invalid chunk
    a, o = ins(range(16))
    case("all_invalid", 64, 64, [
        chunk(64, a, o),
        chunk(64, rng.integers(0, 64, 64), rng.choice([0, 1, 2, 3], 64),
              np.zeros(64, bool))])
    # wider than 1024 rows and than the pool's free space: a pool of 600
    # equal rows (7) and 100 others; then 260 +/- pairs of fresh rows, 280
    # deletes and 260 inserts of row 7 and 40 fresh inserts (520 contested
    # inserts, 600 candidate slots, 20 cleared), in random order; then 1100
    # fresh inserts (overflow)
    fill = np.concatenate([np.full(600, 7), np.arange(1000, 1100)])
    fill = fill[rng.permutation(700)]
    pairs = np.arange(2000, 2260)
    idx = np.concatenate([pairs, pairs, np.full(280, 7), np.full(260, 7),
                          np.arange(2300, 2340)])
    ops = np.concatenate([np.zeros(260), np.ones(260), np.full(280, 2),
                          np.full(260, 3), np.zeros(40)]).astype(np.int8)
    order = rng.permutation(1100)
    case("wide", 1024, 1100, [
        chunk(1100, fill, np.zeros(700, np.int8)),
        chunk(1100, idx[order], ops[order]),
        chunk(1100, *ins(range(2400, 3500)))])
    return out


def k16_chunk_columns(case: dict, idx) -> list:
    """The numpy columns of a K16 case's rows ``idx``."""
    return [(c[0][idx], c[1][idx]) if isinstance(c, tuple) else c[idx]
            for c in case["rows"]]


def k16_schema():
    from risingwave_tpu_torch.common.types import DataType, Field, Schema

    return Schema(tuple(Field(n, getattr(DataType, t), str_width=w or 16)
                        for n, t, w in K16_FIELDS))


def k16_torch_case(torch, case: dict, device):
    """(TopNState-like pool: rows, valid, row_hash, overflow,
    inconsistency; the Chunks) of a K16 case for the port."""
    from risingwave_tpu_torch.common.chunk import Chunk, StrCol

    S = case["S"]
    schema = k16_schema()

    def t(a):
        return torch.from_numpy(a.copy()).to(device)

    chunks = []
    for idx, ops, valid in case["chunks"]:
        cols = [StrCol(t(c[0]), t(c[1])) if isinstance(c, tuple) else t(c)
                for c in k16_chunk_columns(case, idx)]
        chunks.append(Chunk(tuple(cols), t(ops), t(valid), schema))
    rows = tuple(StrCol(torch.zeros((S, c.data.shape[1]), dtype=torch.uint8,
                                    device=device),
                        torch.zeros(S, dtype=torch.int32, device=device))
                 if isinstance(c, StrCol) else
                 torch.zeros(S, dtype=c.dtype, device=device)
                 for c in chunks[0].columns)
    i64 = dict(dtype=torch.int64, device=device)
    pool = (rows, torch.zeros(S, dtype=torch.bool, device=device),
            torch.zeros(S, **i64), torch.zeros((), **i64),
            torch.zeros((), **i64))
    return pool, chunks


def _pool_pairs(tag, a, b) -> list:
    """Named (kernel, plain) tensors of two pools as ``k16_torch_case``
    makes them."""
    from risingwave_tpu_torch.common.tree import flatten

    la, lb = flatten(a)[0], flatten(b)[0]
    # copies: the pools change after this call
    return [(f"{tag} leaf {i}", x.clone(), y.clone())
            for i, (x, y) in enumerate(zip(la, lb))]


def k16_case_pairs(torch, device, kernel) -> list:
    """Every ``k16_cases`` script through ``kernel`` (K16's wrapper, or
    the CPU's ``pool_apply``) and ``pool_apply_plain``, chunk by chunk:
    the named pairs to compare."""
    from risingwave_tpu_torch.common.tree import tree_map
    from risingwave_tpu_torch.stream import top_n

    pairs = []
    for case in k16_cases():
        a, chunks = k16_torch_case(torch, case, device)
        b = tree_map(torch.clone, a)
        for k, c in enumerate(chunks):
            kernel(*a[:3], c, case["S"], *a[3:])
            *_, n_over, n_miss = top_n.pool_apply_plain(*b[:3], c,
                                                        case["S"])
            b[3].add_(n_over)
            b[4].add_(n_miss)
            pairs += _pool_pairs(f"topn_pool {case['name']} chunk {k}",
                                 a, b)
    return pairs


#: K16's wide card case: a chunk and a pool past one tile a block
#: (512 rows, 16 x 512 slots) on any grid of co-resident blocks
K16_WIDE_ROWS, K16_WIDE_POOL = 1 << 19, 1 << 23


def k16_wide_pairs(torch, device, kernel) -> tuple[list, dict]:
    """K16 on the card with every block's rows and pool slots over
    several tiles: a pool of ``K16_WIDE_POOL`` slots, 94% live, each slot
    one of 4000 distinct rows (~1970 copies a row), and two chunks of
    ``K16_WIDE_ROWS`` rows (90% visible) applied in turn.  The first
    inserts rows 0-3899 only; the second inserts them too, among 24
    deletes of rows 3900-3907 (none inserted: each clears its row's first
    three copies in slot order), 16 deletes of rows 0-7 (contested) and 8
    of rows 4000-4007 (in no pool slot: missing).  Together the inserts
    outnumber the free slots.  Returns the named pairs against
    ``pool_apply_plain`` and what the second chunk held."""
    import numpy as np

    from risingwave_tpu_torch.common.chunk import Chunk, StrCol
    from risingwave_tpu_torch.common.hash import hash64_columns
    from risingwave_tpu_torch.common.tree import tree_map
    from risingwave_tpu_torch.stream import top_n

    props = torch.cuda.get_device_properties(device)
    most = props.multi_processor_count * (
        props.max_threads_per_multi_processor // 512)
    S, cap = K16_WIDE_POOL, K16_WIDE_ROWS
    if cap <= most * 512 or S <= most * 16 * 512:
        fail(f"topn_pool wide case: {cap} rows and {S} slots fit one tile "
             f"a block on a grid of {most}")
    rng = np.random.default_rng(1619)
    table = _k16_rows(rng, 4096)
    schema = k16_schema()

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    dev_table = [StrCol(t(c[0]), t(c[1])) if isinstance(c, tuple) else t(c)
                 for c in table]

    def cols(idx):
        ix = t(idx)
        return tuple(StrCol(c.data[ix], c.lens[ix]) if isinstance(c, StrCol)
                     else c[ix] for c in dev_table)

    def ins_ops(n):
        return rng.choice(np.array([0, 3], np.int8), n)

    rows = cols(rng.integers(0, 4000, S))
    i64 = dict(dtype=torch.int64, device=device)
    a = (rows, t(rng.random(S) < 0.94), hash64_columns(list(rows)),
         torch.zeros((), **i64), torch.zeros((), **i64))
    dels = np.concatenate([np.repeat(np.arange(3900, 3908), 3),
                           np.repeat(np.arange(8), 2),
                           np.arange(4000, 4008)])
    del_ops = rng.choice(np.array([1, 2], np.int8), dels.shape[0])
    idx2 = np.concatenate([dels, rng.integers(0, 3900, cap - dels.shape[0])])
    ops2 = np.concatenate([del_ops, ins_ops(cap - dels.shape[0])])
    order = rng.permutation(cap)
    valid2 = np.ones(cap, bool)
    valid2[dels.shape[0]:] = rng.random(cap - dels.shape[0]) < 0.9
    script = [(rng.integers(0, 3900, cap), ins_ops(cap),
               rng.random(cap) < 0.9),
              (idx2[order], ops2[order], valid2[order])]
    b = tree_map(torch.clone, a)
    pairs = []
    for k, (idx, ops, valid) in enumerate(script):
        c = Chunk(cols(idx), t(ops), t(valid), schema)
        kernel(*a[:3], c, S, *a[3:])
        *_, n_over, n_miss = top_n.pool_apply_plain(*b[:3], c, S)
        b[3].add_(n_over)
        b[4].add_(n_miss)
        pairs += _pool_pairs(f"topn_pool wide chunk {k}", a, b)
    held = dict(grid_most=most, overflow=int(a[3]), missing=int(a[4]),
                live=int(a[1].sum()))
    if held["overflow"] == 0 or held["missing"] != 8:
        fail(f"topn_pool wide case missed a branch: {held}")
    return pairs, held


#: the K18 cases' pool rows: an int64 order key (distinct), an int64, a
#: 3-, a 16- and a 40-byte string (random bytes past their lengths) and a
#: timestamp
K18_FIELDS = (("a", "INT64", 0), ("b", "INT64", 0), ("s3", "VARCHAR", 3),
              ("s16", "VARCHAR", 16), ("s40", "VARCHAR", 40),
              ("t", "TIMESTAMP", 0))
#: the reference's rank fold (h ^ rank * K, wrapping)
K18_GOLDEN = 0x9E3779B97F4A7C15


def _k18_rows(rng, n: int, keys=None) -> list:
    """Columns of ``n`` rows of ``K18_FIELDS`` (numpy; strings as (bytes,
    lengths)); ``keys`` the order key, else a random permutation."""
    import numpy as np

    cols = [rng.permutation(n).astype(np.int64) * 7 - 1000
            if keys is None else keys,
            rng.integers(-50, 50, n).astype(np.int64)]
    for _, kind, w in K18_FIELDS[2:5]:
        cols.append((rng.integers(0, 256, (n, w)).astype(np.uint8),
                     rng.integers(0, w + 1, n).astype(np.int32)))
    cols.append(rng.integers(0, 10**12, n).astype(np.int64))
    return cols


def k18_cases() -> list:
    """K18's corner cases, shared with
    ``tests/test_torch_flush_window_grid.py``: dicts with the pool size
    ``S``, the band capacity ``E``, ``rank`` (a rank column or none),
    the pool (``rows``, ``valid``, ``row_hash``) and the emitted band
    (``prev_rows``, with the rank column last when ``rank``,
    ``prev_valid``, ``prev_hash``).  The top-N has no group, orders by the
    distinct key ``a`` and its limit takes every valid row, so the band's
    entry c is the c-th valid slot (the first E of them) and its hash is
    crafted through ``row_hash`` (the rank folded back out): equal hashes
    on both sides with more live entries on either, live entries that
    hash to 0, an all-dead side, an all-equal side, and E off the
    kernel's tiles (256 entries a gather block, 512 a scan or merge
    tile).  Hashes are int64 bit patterns."""
    import numpy as np

    rng = np.random.default_rng(1819)
    cases = []

    def alphabet(n):
        return rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)

    def case(name, S, E, rank, n_valid, new_h, prev_h, prev_live):
        """``new_h``: the hash wanted for each of the band's live entries
        (in slot order); ``prev_h`` / ``prev_live``: the emitted band's
        [E] hashes and flags (dead entries hash 0)."""
        rows = _k18_rows(rng, S)
        valid = np.zeros(S, bool)
        valid[rng.choice(S, n_valid, replace=False)] = True
        slots = np.flatnonzero(valid)[:E]
        # rank: 1 + the valid rows with a smaller key
        keys = rows[0]
        order = np.argsort(np.where(valid, keys, np.iinfo(np.int64).max),
                           kind="stable")
        ranks = np.zeros(S, np.int64)
        ranks[order[:n_valid]] = np.arange(1, n_valid + 1)
        row_hash = alphabet(S)
        want = np.asarray(new_h, np.int64)[:len(slots)].view(np.uint64)
        if rank:
            fold = ranks[slots].astype(np.uint64) * np.uint64(K18_GOLDEN)
            want = want ^ fold
        row_hash[slots] = want.view(np.int64)
        prev_rows = _k18_rows(rng, E)
        if rank:
            prev_rows.append(np.where(prev_live, rng.integers(1, 99, E), 0)
                             .astype(np.int64))
        cases.append(dict(
            name=name, S=S, E=E, rank=rank, rows=rows, valid=valid,
            row_hash=row_hash, prev_rows=prev_rows,
            prev_valid=np.asarray(prev_live, bool),
            prev_hash=np.where(prev_live, prev_h, 0).astype(np.int64)))

    # equal hashes, more live copies on either side: H0 5 new / 2 old, H1
    # 1 new / 4 old, H2 3 / 3; the rest shared or fresh
    H = alphabet(3)
    for rank in (False, True):
        E, n_valid = 96, 80
        new = np.concatenate([np.repeat(H, [5, 1, 3]), alphabet(71)])
        rng.shuffle(new)
        prev = np.concatenate([np.repeat(H, [2, 4, 3]),
                               rng.choice(new[new != H[0]], 30),
                               alphabet(31), np.zeros(26, np.int64)])
        live = np.concatenate([np.ones(70, bool), np.zeros(26, bool)])
        perm = rng.permutation(E)
        case(f"counts_both_ways{'_rank' if rank else ''}", 160, E, rank,
             n_valid, new, prev[perm], live[perm])
    # live entries hashing to 0 on both sides, beside the dead ones
    new = np.concatenate([np.zeros(3, np.int64), np.repeat(H[:1], 2),
                          alphabet(35)])
    prev = np.concatenate([np.zeros(1, np.int64), np.repeat(H[:1], 2),
                           alphabet(20), np.zeros(25, np.int64)])
    live = np.concatenate([np.ones(23, bool), np.zeros(25, bool)])
    case("live_hash_zero", 64, 48, False, 40, new, prev, live)
    # an all-dead old side (the first flush), an all-dead new side
    case("prev_all_dead", 96, 64, True, 50, alphabet(50),
         np.zeros(64, np.int64), np.zeros(64, bool))
    case("new_all_dead", 64, 64, False, 0, [], alphabet(64),
         rng.random(64) < 0.7)
    # an all-equal new side (E live copies of one hash) against fewer
    case("all_equal_rank", 80, 64, True, 72, np.full(72, H[2]),
         np.where(np.arange(64) < 40, H[2], alphabet(64)),
         np.arange(64) < 52)
    # E past the tiles: 700 and 600 entries, 50 and 30 distinct hashes
    A = alphabet(50)
    case("wide_tiles", 900, 700, False, 650, rng.choice(A, 650),
         rng.choice(A, 700), rng.random(700) < 0.85)
    B = alphabet(30)
    case("wide_tiles_rank", 1100, 600, True, 1000, rng.choice(B, 1000),
         rng.choice(B, 600), rng.random(600) < 0.9)
    return cases


def k18_schema():
    from risingwave_tpu_torch.common.types import DataType, Field, Schema

    return Schema(tuple(Field(n, getattr(DataType, t), str_width=w or 16)
                        for n, t, w in K18_FIELDS))


def k18_torch_case(torch, case: dict, device):
    """(GroupTopNExecutor, TopNState) of a K18 case for the port."""
    from risingwave_tpu_torch.common.chunk import StrCol
    from risingwave_tpu_torch.expr.node import InputRef
    from risingwave_tpu_torch.stream.top_n import (
        GroupTopNExecutor, TopNState)

    S, E = case["S"], case["E"]
    ex = GroupTopNExecutor(k18_schema(), [], [(InputRef(0), False)], S,
                           pool_size=S, emit_capacity=E,
                           rank_alias="rn" if case["rank"] else None)

    def t(a):
        return torch.from_numpy(a.copy()).to(device)

    def col(c):
        return StrCol(t(c[0]), t(c[1])) if isinstance(c, tuple) else t(c)

    i64 = dict(dtype=torch.int64, device=device)
    st = TopNState(
        rows=tuple(col(c) for c in case["rows"]), valid=t(case["valid"]),
        row_hash=t(case["row_hash"]),
        prev_rows=tuple(col(c) for c in case["prev_rows"]),
        prev_valid=t(case["prev_valid"]), prev_hash=t(case["prev_hash"]),
        overflow=torch.zeros((), **i64), inconsistency=torch.zeros((), **i64))
    return ex, st


def _diff_planes(res):
    """Named tensors of a band diff (out columns [2E], out valid, the new
    band, its liveness and hashes)."""
    from risingwave_tpu_torch.common.chunk import StrCol

    cols, valid, cur, live, h = res
    out_p = [("valid", valid), ("cur_live", live), ("cur_hash", h)]
    for tag, group in (("out", cols), ("band", cur)):
        for j, c in enumerate(group):
            if isinstance(c, StrCol):
                out_p += [(f"{tag} col {j} bytes", c.data),
                          (f"{tag} col {j} lens", c.lens)]
            else:
                out_p.append((f"{tag} col {j}", c))
    return out_p


def k18_case_pairs(torch, device, kernel) -> list:
    """Every ``k18_cases`` case through ``kernel`` (K18's wrapper
    ``band_diff_cuda``, or the plain version) and ``band_diff_plain`` on
    the same band: the named pairs to compare."""
    from risingwave_tpu_torch.common.compact import mask_indices
    from risingwave_tpu_torch.stream import top_n

    pairs = []
    for case in k18_cases():
        ex, st = k18_torch_case(torch, case, device)
        band, ranks = ex._band_mask(st)
        cur_idx = mask_indices(band, case["E"], case["S"])
        args = (st.rows, st.row_hash, ranks if case["rank"] else None,
                cur_idx, st.prev_rows, st.prev_valid, st.prev_hash)
        got = kernel(*args)
        want = top_n.band_diff_plain(*args)
        pairs += [(f"topn_flush {case['name']} {n}", x, y) for (n, x), (_, y)
                  in zip(_diff_planes(got), _diff_planes(want))]
    return pairs


def phase_topn_kernels(torch, device, timer, scale):
    """K16-K18 at the q19 path's shapes (pool 2^18, emitted band 2^16,
    8192-row chunks of whole bids) on the TopN state of a q19 engine
    after 9 barriers; K16's delete and annihilation branches on a
    retractable chunk against a pool of 2^14 (where the plain version's
    match matrix fits); K1 on the bid rows with random bytes past the
    strings' lengths and K3 on the MV's whole-row key (strings included)
    with the flush's 2^17-row chunk.  Every result exactly equal to the
    plain version."""
    from risingwave_tpu_torch.common.chunk import Chunk, StrCol
    from risingwave_tpu_torch.common.compact import mask_indices
    from risingwave_tpu_torch.common.hash import (
        hash64_columns, hash64_columns_cuda, hash64_columns_plain)
    from risingwave_tpu_torch.common.tree import flatten, tree_map
    from risingwave_tpu_torch.stream import top_n
    from risingwave_tpu_torch.stream.materialize import (
        mv_upsert_cuda, mv_upsert_plain)

    cuda = device.type == "cuda"
    eng = _topn_engine(torch, device, scale, "q19",
                       WARMUP_BARRIERS if device.type == "cuda" else 1)
    job = eng.jobs[0]
    ti = _topn_index(eng)
    tex = job.fragment.executors[ti]
    S, E = tex.pool_size, tex.emit_capacity
    base = job.states[ti]
    chunks = _topn_inputs(torch, eng, CHUNKS_PER_BARRIER)
    cap = chunks[0].capacity
    pool_apply_k = top_n.pool_apply_cuda if cuda else \
        (lambda *a: top_n.pool_apply(*a))
    out = {}

    # -- K16 on the insert-only path ----------------------------------
    a = tree_map(torch.clone, base)
    b = tree_map(torch.clone, base)
    n_pool0 = int(a.valid.sum())
    pairs = []
    for k, c in enumerate(chunks):
        pool_apply_k(a.rows, a.valid, a.row_hash, c, S, a.overflow,
                     a.inconsistency)
        _, _, _, n_over, n_miss = top_n.pool_apply_plain(
            b.rows, b.valid, b.row_hash, c, S)
        b.overflow.add_(n_over)
        b.inconsistency.add_(n_miss)
        pairs += [(f"topn_pool chunk {k} {n}", x, y) for (n, x), (_, y)
                  in zip(_topn_planes("pool", a), _topn_planes("pool", b))]
    # -- K16 on every k16_cases script, and on the card the wide case
    # (each block's rows and slots over several tiles) -------------------
    n_cases = len(k16_cases())
    pairs += k16_case_pairs(torch, device, pool_apply_k)
    wide = None
    if cuda:
        wide_pairs, wide = k16_wide_pairs(torch, device, pool_apply_k)
        pairs += wide_pairs
        del wide_pairs
    err = max_abs_err(torch, pairs)
    n_pool1 = int(a.valid.sum())
    last = int(torch.nonzero(a.valid).max()) + 1 if n_pool1 else 0

    # -- K16's delete and annihilation branches, pool 2^14 ---------------
    g = torch.Generator(device="cpu").manual_seed(16)
    small_s = 1 << 14
    small = base._replace(
        rows=tuple(top_n._empty_like_col(r, small_s) for r in base.rows),
        valid=torch.zeros(small_s, dtype=torch.bool, device=device),
        row_hash=torch.zeros(small_s, dtype=torch.int64, device=device))
    for c in chunks[:2]:
        top_n.pool_apply_plain(small.rows, small.valid, small.row_hash, c,
                               small_s)
    rc = _retractable_chunk(torch, small, cap, g, chunks[0].schema)
    sa, sb = tree_map(torch.clone, small), tree_map(torch.clone, small)
    pool_apply_k(sa.rows, sa.valid, sa.row_hash, rc, small_s, sa.overflow,
                 sa.inconsistency)
    _, _, _, n_over, n_miss = top_n.pool_apply_plain(
        sb.rows, sb.valid, sb.row_hash, rc, small_s)
    sb.overflow.add_(n_over)
    sb.inconsistency.add_(n_miss)
    err = max(err, max_abs_err(torch, [
        (f"topn_pool retractable {n}", x, y) for (n, x), (_, y)
        in zip(_topn_planes("small", sa), _topn_planes("small", sb))]))
    full = int(small.valid.sum()) == small_s
    held = (int(small.valid.sum()), int(sa.valid.sum()))
    if int(sa.inconsistency) == 0 or (full and int(sa.overflow) == 0):
        fail("topn_pool: the retractable chunk missed a branch (missing "
             f"{int(sa.inconsistency)}, over {int(sa.overflow)})")

    t = tree_map(torch.clone, base)
    ms = timer(lambda i: pool_apply_k(t.rows, t.valid, t.row_hash,
                                      chunks[i % len(chunks)], S,
                                      t.overflow, t.inconsistency), 8)
    t = tree_map(torch.clone, base)
    plain_ms = timer(lambda i: top_n.pool_apply_plain(
        t.rows, t.valid, t.row_hash, chunks[i % len(chunks)], S), 3,
        TOPN_PREFILL_MS)
    wide_note = "" if wide is None else (
        f"; the wide case ({K16_WIDE_ROWS} rows a chunk into "
        f"{K16_WIDE_POOL} slots, a grid of at most {wide['grid_most']} "
        f"blocks: {wide['missing']} deletes missing, {wide['overflow']} "
        f"inserts over)")
    # the chunk read (payload, hash, op, valid), the claimed rows and
    # hashes written, and the validity scanned up to the last claimed slot
    b16 = bound(cap * (BID_ROW_BYTES + 10) + cap * (BID_ROW_BYTES + 9)
                + last, cap * 40)
    print(f"[topn_pool] exact (8 insert chunks into a pool of {n_pool0} -> "
          f"{n_pool1} of {S} rows; {n_cases} edge-case scripts"
          f"{wide_note}; "
          f"retractable chunk at pool {small_s}: "
          f"{held[0]} -> {held[1]} rows, {int(sa.inconsistency)} deletes "
          f"missing, {int(sa.overflow)} inserts over); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b16[0]:.5f} ms", flush=True)
    out["topn_pool"] = kernel_entry(
        "topn_pool.cu", "risingwave_tpu/stream/top_n.py:134", ms, plain_ms,
        b16, None, err)

    # -- K17 over the filled pool --------------------------------------
    order_cols, desc, group_cols = tex.band_inputs(a)
    args = (order_cols, desc, group_cols, a.valid, tex.offset, tex.limit)
    band_k = top_n.band_mask_cuda if cuda else top_n.band_mask_plain
    band, ranks = band_k(*args)
    pband, pranks = top_n.band_mask_plain(*args)
    err = max_abs_err(torch, [("topn_band band", band, pband),
                              ("topn_band ranks", ranks, pranks)])
    n_band = int(band.sum())
    ms = timer(lambda i: band_k(*args), 20, TOPN_PREFILL_MS)
    plain_ms = timer(lambda i: top_n.band_mask_plain(*args), 5,
                     TOPN_PREFILL_MS)
    # read: the order and group columns and validity; written: band, rank
    b17 = bound(S * (8 + 8 + 1) + S * (1 + 8), S * 30)
    print(f"[topn_band] exact ({n_band} band rows of {n_pool1} in a pool of "
          f"{S}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{b17[0]:.5f} ms", flush=True)
    out["topn_band"] = kernel_entry(
        "topn_band.cu", "risingwave_tpu/stream/top_n.py:295", ms, plain_ms,
        b17, None, err)

    # -- K18: the band diff against the emitted band ----------------------
    cur_idx = mask_indices(band, E, S)
    dargs = (a.rows, a.row_hash, ranks, cur_idx, base.prev_rows,
             base.prev_valid, base.prev_hash)
    diff_k = top_n.band_diff_cuda if cuda else top_n.band_diff_plain
    kres = diff_k(*dargs)
    pres = top_n.band_diff_plain(*dargs)

    err = max_abs_err(torch, [(f"topn_flush {n}", x, y) for (n, x), (_, y)
                              in zip(_diff_planes(kres), _diff_planes(pres))])
    # every k18_cases case (the CPU's wrapper is the plain version)
    err = max(err, max_abs_err(torch, k18_case_pairs(torch, device,
                                                     diff_k)))
    n_out = int(kres[1].sum())
    ms = timer(lambda i: diff_k(*dargs), 20, TOPN_PREFILL_MS)
    split = device_ms_by_kernel(torch, device, lambda i: diff_k(*dargs), 10,
                                K18_KERNELS + (RADIX_SORT,))
    plain_ms = timer(lambda i: top_n.band_diff_plain(*dargs), 5,
                     TOPN_PREFILL_MS)
    row = BID_ROW_BYTES + 8                    # with the rank column
    # read: the old band and its hashes and flags, the band indices and
    # the band's pool rows, hashes and ranks; written: the [2E] chunk and
    # its flags, the new band's rows, hashes and flags
    b18 = bound(E * (row + 9) + E * 4 + E * (BID_ROW_BYTES + 16)
                + 2 * E * (row + 1) + E * (row + 9), E * 200)
    by_kernel = "" if split is None else (
        " (device time: " + ", ".join(
            f"{k.split('::')[-1]} {v:.4f}" for k, v in split.items())
        + " ms)")
    print(f"[topn_flush] exact ({n_band} band rows against "
          f"{int(base.prev_valid.sum())} emitted: {n_out} changelog rows of "
          f"{2 * E}; {len(k18_cases())} edge cases); kernel {ms:.4f} "
          f"ms{by_kernel}, plain {plain_ms:.4f} ms, bound {b18[0]:.5f} ms",
          flush=True)
    out["topn_flush"] = kernel_entry(
        "topn_flush.cu", "risingwave_tpu/stream/top_n.py:337", ms, plain_ms,
        b18, None, err)
    if split is not None:
        out["topn_flush"]["device_ms_by_kernel"] = split
    out["topn_flush"]["membership_at_ow_bid"] = phase_k18_ow_bid(
        torch, device, timer, scale)

    # -- K1 and K3 with strings --------------------------------------------
    cols = []
    for c in chunks[0].columns:
        if isinstance(c, StrCol):
            # random bytes past every length: the hash must mask them
            w = c.data.shape[1]
            junk = torch.randint(0, 256, tuple(c.data.shape), generator=g,
                                 dtype=torch.uint8).to(device)
            past = torch.arange(w, device=device)[None, :] >= \
                c.lens[:, None]
            c = StrCol(torch.where(past, junk, c.data), c.lens)
        cols.append(c)
    hk = hash64_columns_cuda(cols)[0] if cuda else \
        hash64_columns_plain(cols)
    clean = hash64_columns_plain(list(chunks[0].columns))
    err = max_abs_err(torch, [("hash64 strings", hk,
                               hash64_columns_plain(cols)),
                              ("hash64 strings masked", hk, clean)])
    hfn = (lambda i: hash64_columns_cuda(cols)) if cuda else \
        (lambda i: hash64_columns_plain(cols))
    h_ms = timer(hfn, 200)
    h_plain = timer(lambda i: hash64_columns_plain(cols), 20,
                    TOPN_PREFILL_MS)
    # 13 words folded per row (4 ints, 2 + 1 and 5 + 1 string words)
    bh = bound(cap * (BID_ROW_BYTES + 8), cap * 13 * 12)
    print(f"[hash64] exact on {cap} bid rows with strings (random bytes "
          f"past the lengths, masked); kernel {h_ms:.4f} ms, plain "
          f"{h_plain:.4f} ms, bound {bh[0]:.5f} ms", flush=True)
    strings = {"hash64": dict(shape=f"{cap} bid rows, 6 columns",
                              ms=h_ms, plain_ms=h_plain, bound_ms=bh[0],
                              bound_by=bh[1], max_abs_err=err)}

    mi = len(job.fragment.executors) - 1
    mex = job.fragment.executors[mi]
    mv = job.states[mi]
    outc = Chunk(kres[0], tex._ops_for(device), kres[1], tex.out_schema)
    for i in range(ti + 1, mi):
        _, outc = job.fragment.executors[i].apply((), outc)
    keys = [outc.column(i) for i in mex.pk_indices]
    ta, tb = mv.table.clone(), mv.table.clone()
    if cuda:
        ra = ta._probe_cuda(keys, outc.valid, True)
    else:
        ra = ta._probe_plain(keys, outc.valid, True)
    rb = tb._probe_plain(keys, outc.valid, True)
    pairs = [(f"probe strings {n}", x, y) for n, x, y in zip(
        ("slots", "inserted", "overflow", "n_over"), ra[1:], rb[1:])]
    pairs += [(f"probe strings table {n}", x, y) for n, x, y in (
        ("occupied", ta.occupied, tb.occupied),
        ("tombstone", ta.tombstone, tb.tombstone))]
    for j, (x, y) in enumerate(zip(ta.key_cols, tb.key_cols)):
        if isinstance(x, StrCol):
            pairs += [(f"key {j} bytes", x.data, y.data),
                      (f"key {j} lens", x.lens, y.lens)]
        else:
            pairs.append((f"key {j}", x, y))
    # K8's upsert of the same 2^17-row chunk (wider than chunk_capacity)
    va = tree_map(torch.clone, mv.values)
    vb = tree_map(torch.clone, mv.values)
    if cuda:
        mv_upsert_cuda(ta, va, outc, ra[1], mex._scratch_for(device))
    else:
        mv_upsert_plain(ta, va, outc, ra[1])
    mv_upsert_plain(tb, vb, outc, rb[1])
    pairs += [(f"mv_upsert 2E value leaf {j}", x, y) for j, (x, y)
              in enumerate(zip(flatten(va)[0], flatten(vb)[0]))]
    pairs += [("mv_upsert 2E occupied", ta.occupied, tb.occupied),
              ("mv_upsert 2E tombstone", ta.tombstone, tb.tombstone)]
    err = max_abs_err(torch, pairs)
    n_rows = int(outc.valid.sum())
    tl = mv.table.clone()
    # K3 alone: the hashes (K1) computed before the timed calls
    hk = hash64_columns(keys)
    pfn = (lambda i: tl._probe_cuda(keys, outc.valid, False, hk)) if cuda \
        else (lambda i: tl._probe_plain(keys, outc.valid, False))
    p_ms = timer(pfn, 20)
    p_plain = timer(lambda i: tl._probe_plain(keys, outc.valid, False), 3,
                    4 * TOPN_PREFILL_MS)
    n = outc.capacity
    bp = probe_bound(n, n_rows, 0, row)
    print(f"[probe] exact on the MV's whole-row key (7 columns, strings "
          f"included), and K8's upsert after it: {n_rows} visible of {n} "
          f"rows into {mv.table.size}; "
          f"kernel {p_ms:.4f} ms, plain {p_plain:.4f} ms, bound "
          f"{bp[0]:.5f} ms", flush=True)
    strings["probe"] = dict(shape=f"{n} rows ({n_rows} visible), 7 key "
                            f"columns, into {mv.table.size}", ms=p_ms,
                            plain_ms=p_plain, bound_ms=bp[0],
                            bound_by=bp[1], max_abs_err=err)
    del eng, a, b, t, tl, ta, tb
    if cuda:
        torch.cuda.empty_cache()
    return out, strings


def phase_topn_parity(torch, device, query: str) -> None:
    """``query`` at 2 events/s through the engine on ``device`` and on
    the CPU (plain versions), chunk 256, pool 4096, emitted band 1024, MV
    table 2^12, 10 barriers: MV rows and every state tensor (the pool,
    the emitted band with its row-S-1 copies, the MV) must be equal."""
    from risingwave_tpu_torch.compat import state_mismatches, state_to_numpy
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig

    cfg = PlannerConfig(chunk_capacity=256, topn_pool_size=4096,
                        topn_emit_capacity=1024, mv_table_size=1 << 12)
    engines = []
    for dev in (device, torch.device("cpu")):
        eng = Engine(cfg, device=dev)
        eng.execute(BENCH_SOURCES.replace("'1000000'", "'2'"))
        eng.execute(QUERY_SQL[query])
        eng.tick(barriers=10, chunks_per_barrier=4)
        engines.append(eng)
    rows = [sorted(tuple(v if isinstance(v, str) else _host_value(v)
                         for v in r) for r in e.execute(
                             "SELECT * FROM bench_mv"))
            for e in engines]
    if rows[0] != rows[1] or not rows[0]:
        fail(f"{query} MV on the card differs from the CPU plain versions")
    bad = state_mismatches(state_to_numpy(engines[1].jobs[0].states),
                           engines[0].jobs[0].states)
    if bad:
        fail(f"{query} state on the card differs from the CPU: {bad[:5]}")
    st = engines[0].jobs[0].states[_topn_index(engines[0])]
    print(f"[parity] {query} at 2 events/s, 10 barriers: {len(rows[0])} MV "
          f"rows and all state equal to the CPU plain versions (pool "
          f"{int(st.valid.sum())} rows, band {int(st.prev_valid.sum())})",
          flush=True)


def _consumed_bids_full(eng, cap: int):
    """Every column of every bid the job consumed, regenerated on the
    card: numpy int64 columns and the strings' bytes and lengths."""
    import numpy as np

    reader = eng.jobs[0].source
    cols = {k: [] for k in ("auction", "bidder", "price", "ts", "ch", "chl",
                            "url", "urll")}
    for i in range(reader.offset // cap):
        c = reader.gen.gen_bids(i * cap, cap)
        for name, j in (("auction", 0), ("bidder", 1), ("price", 2),
                        ("ts", 5)):
            cols[name].append(c.columns[j].cpu().numpy())
        for name, j in (("ch", 3), ("url", 4)):
            cols[name].append(c.columns[j].data.cpu().numpy())
            cols[name + "l"].append(c.columns[j].lens.cpu().numpy())
    return {k: np.concatenate(v) for k, v in cols.items()}


def _mv_bids(eng, bids, rank: bool):
    """The MV's rows as numpy (auction, bidder, price, ts[, rank]), each
    required to be a consumed bid, strings included (a bid's date_time
    is unique at 1M events/s)."""
    import numpy as np

    from risingwave_tpu_torch.common.chunk import decode_strings

    rows = eng.execute("SELECT * FROM bench_mv")
    mv = np.asarray([(r[0], r[1], r[2], r[5]) + ((r[6],) if rank else ())
                     for r in rows], np.int64).reshape(len(rows), -1)
    ts = bids["ts"]
    order = np.argsort(ts, kind="stable")
    if np.unique(ts).shape[0] != ts.shape[0]:
        fail("consumed bids share a date_time: the MV check needs them "
             "unique")
    pos = order[np.searchsorted(ts[order], mv[:, 3])]
    if not (np.array_equal(ts[pos], mv[:, 3])
            and np.array_equal(bids["auction"][pos], mv[:, 0])
            and np.array_equal(bids["bidder"][pos], mv[:, 1])
            and np.array_equal(bids["price"][pos], mv[:, 2])):
        fail("an MV row is not a consumed bid")
    ch = decode_strings(bids["ch"][pos], bids["chl"][pos])
    url = decode_strings(bids["url"][pos], bids["urll"][pos])
    if [r[3] for r in rows] != list(ch) or [r[4] for r in rows] != list(url):
        fail("an MV row's channel or url differs from its bid's")
    return mv


def check_q19(eng, bids) -> str:
    """Per auction, the MV's prices sorted descending are the top
    min(10, n) consumed prices, with ranks 1..k."""
    import numpy as np

    mv = _mv_bids(eng, bids, rank=True)
    auc, price = bids["auction"], bids["price"]
    order = np.lexsort((-price, auc))
    a_s, p_s = auc[order], price[order]
    first = np.r_[True, a_s[1:] != a_s[:-1]]
    start = np.maximum.accumulate(np.where(first, np.arange(a_s.size), 0))
    top = (np.arange(a_s.size) - start) < 10
    want = np.stack([a_s[top], p_s[top]], 1)
    got = mv[np.lexsort((-mv[:, 2], mv[:, 0]))][:, [0, 2]]
    if not np.array_equal(got, want):
        fail(f"q19 MV ({got.shape[0]} rows) differs from the numpy top-10 "
             f"prices per auction ({want.shape[0]} rows)")
    by_rank = mv[np.lexsort((mv[:, 4], mv[:, 0]))]
    f2 = np.r_[True, by_rank[1:, 0] != by_rank[:-1, 0]]
    s2 = np.maximum.accumulate(np.where(f2, np.arange(len(by_rank)), 0))
    if not np.array_equal(by_rank[:, 4], np.arange(len(by_rank)) - s2 + 1):
        fail("q19 MV ranks are not 1..k per auction")
    return (f"MV equals numpy top-10 prices per auction with ranks 1..k "
            f"over {auc.size} bids ({np.unique(auc).size} auctions, "
            f"{mv.shape[0]} rows), every row a consumed bid")


def check_q18(eng, bids) -> str:
    """One MV row per (bidder, auction): the bid with the latest
    date_time."""
    import numpy as np

    mv = _mv_bids(eng, bids, rank=False)
    auc, bidder, ts = bids["auction"], bids["bidder"], bids["ts"]
    order = np.lexsort((ts, auc, bidder))
    b_s, a_s = bidder[order], auc[order]
    last = np.r_[(b_s[1:] != b_s[:-1]) | (a_s[1:] != a_s[:-1]), True]
    pick = order[last]
    want = np.stack([auc[pick], bidder[pick], bids["price"][pick],
                     ts[pick]], 1)
    want = want[np.lexsort((want[:, 0], want[:, 1]))]
    got = mv[np.lexsort((mv[:, 0], mv[:, 1]))]
    if not np.array_equal(got, want):
        fail(f"q18 MV ({got.shape[0]} rows) differs from numpy's latest bid "
             f"per (bidder, auction) ({want.shape[0]} rows)")
    return (f"MV equals numpy's latest bid per (bidder, auction) over "
            f"{auc.size} bids ({want.shape[0]} rows), every row a consumed "
            f"bid")


def phase_topn_main_path(torch, device, scale, query: str):
    """q19 or q18 at the slice's sizes: 9 warm-up barriers, then 32 timed
    barriers of 8 chunks with the launch counters; every flush's band
    size recorded (it must stay within the emitted capacity, so the run
    is lossless), the TopN's counters audited, the MV checked with
    numpy."""
    from risingwave_tpu_torch import kernels

    eng = _topn_engine(torch, device, scale, query, 0)
    ti = _topn_index(eng)
    tex = eng.jobs[0].fragment.executors[ti]
    peaks = []
    band_mask = tex._band_mask

    def recorded(state):
        band, ranks = band_mask(state)
        peaks.append(band.sum())
        return band, ranks

    tex._band_mask = recorded
    eng.tick(barriers=WARMUP_BARRIERS if device.type == "cuda" else 1,
             chunks_per_barrier=CHUNKS_PER_BARRIER)
    if device.type == "cuda":
        torch.cuda.synchronize()
    kernels.reset_launches()
    barriers = BARRIERS if device.type == "cuda" else 2
    t0 = time.perf_counter()
    eng.tick(barriers=barriers, chunks_per_barrier=CHUNKS_PER_BARRIER)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    cap = eng.jobs[0].source.cap
    chunks = barriers * CHUNKS_PER_BARRIER
    rows = chunks * cap
    rate = rows / dt
    port = sum(launches.values())
    print(f"[main] {query} {rows} rows in {dt:.3f} s = {rate:.0f} rows/s; "
          f"port kernel launches {port / chunks:.2f} per chunk {launches}",
          flush=True)
    if device.type == "cuda":
        per_chunk = profile_window(torch, eng, query)
        print(f"[main] {query} launches per chunk "
              f"{'not measured' if per_chunk is None else f'{per_chunk:.1f}'}"
              f" (all CUDA kernels, profiled window)", flush=True)
    eng.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1")
    try:
        eng.tick(barriers=1, chunks_per_barrier=0)
    except RuntimeError as e:
        fail(f"{query}: the counter audit raised: {e}")
    st = eng.jobs[0].states[ti]
    over, inc = int(st.overflow), int(st.inconsistency)
    band = torch.stack(peaks).cpu().numpy()
    E = tex.emit_capacity
    late = int(eng.jobs[0].states[0].late_rows)
    if over or inc or late or int(band.max()) > E:
        fail(f"{query}: TopN overflow {over}, inconsistency {inc}, late rows "
             f"{late}, largest band {int(band.max())} of capacity {E}")
    print(f"[check] {query} TopN overflow 0, inconsistency 0, no late rows; "
          f"band at each of {band.size} flushes <= {E} (largest "
          f"{int(band.max())}, last {int(band[-1])}): lossless", flush=True)
    bids = _consumed_bids_full(eng, cap)
    msg = {"q19": check_q19, "q18": check_q18}[query](eng, bids)
    print(f"[check] {query} {msg}", flush=True)
    del eng
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return launches, rate


# ---------------------------------------------------------------------------
# q6_bid and ow_bid: the over-window (K20, K19a, float keys in K1/K3)


WINDOW_QUERIES = ("q6_bid", "ow_bid")
#: q6_bid at the top-N's sizes; ow_bid's pool and emitted rows hold every
#: bid of the run (41 barriers of 8 x 8192 = 2,686,976 <= 2^22) and its MV
#: table every row at under half load
WINDOW_CONFIG = {
    "q6_bid": TOPN_CONFIG,
    "ow_bid": dict(BENCH_CONFIG, topn_pool_size=1 << 22,
                   topn_emit_capacity=1 << 22, mv_table_size=1 << 23),
}
#: the CPU rehearsal's sizes (ow_bid at chunk 64: its 43 barriers hold
#: 22,016 bids)
WINDOW_REHEARSAL = {
    "q6_bid": TOPN_REHEARSAL,
    "ow_bid": dict(chunk_capacity=64, topn_pool_size=1 << 15,
                   topn_emit_capacity=1 << 15, mv_table_size=1 << 16),
}
#: the over-window's watermark lag on the executor-level cleaning path
CLEAN_LAG_US = 2_000_000


def _window_engine(torch, device, scale, query: str, barriers: int):
    """A q6_bid or ow_bid engine at the slice's sizes after ``barriers``
    barriers (maintenance off, a snapshot every 8 checkpoints)."""
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig

    cfg = WINDOW_CONFIG[query] if scale == 1 else WINDOW_REHEARSAL[query]
    eng = Engine(PlannerConfig(**cfg), device=device)
    eng.execute(BENCH_SOURCES)
    eng.execute(QUERY_SQL[query])
    eng.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1000000")
    eng.execute("ALTER SYSTEM SET snapshot_interval_checkpoints = 8")
    if barriers:
        eng.tick(barriers=barriers, chunks_per_barrier=CHUNKS_PER_BARRIER)
    return eng


def _executor_index(eng, cls_name: str) -> int:
    return next(i for i, ex in enumerate(eng.jobs[0].fragment.executors)
                if type(ex).__name__ == cls_name)


def _flush_planes(torch, res):
    """Named tensors of a flush result (out columns, out valid, the new
    emitted rows, their liveness and hashes), on the CPU; floats as bit
    patterns."""
    from risingwave_tpu_torch.common.chunk import StrCol

    out_cols, out_valid, cur, live, h = res
    planes = [("out valid", out_valid), ("cur live", live),
              ("cur hash", h)]
    for tag, group in (("out", out_cols), ("cur", cur)):
        for j, c in enumerate(group):
            if isinstance(c, StrCol):
                planes += [(f"{tag} col {j} bytes", c.data),
                           (f"{tag} col {j} lens", c.lens)]
            elif c.dtype.is_floating_point:
                bits = torch.int64 if c.element_size() == 8 else torch.int32
                planes.append((f"{tag} col {j} bits", c.view(bits)))
            else:
                planes.append((f"{tag} col {j}", c))
    return [(n, t.cpu()) for n, t in planes]


def _stress_executor(torch, device, S: int, E: int, g):
    """An over-window of every call kind on a synthetic pool of S rows:
    90% of the rows in one partition, tie-heavy negative keys, strings,
    dyadic float64/float32 values, int32 values and ROWS frames; a
    partition hash and two order keys.  Returns (executor, state)."""
    from risingwave_tpu_torch.common.chunk import StrCol
    from risingwave_tpu_torch.common.types import DataType, Field, Schema
    from risingwave_tpu_torch.expr.node import InputRef as R
    from risingwave_tpu_torch.stream.over_window import (
        OverWindowExecutor, WindowFuncCall as C)

    names = (("p", "INT64", 16), ("v", "INT64", 16), ("s", "VARCHAR", 6),
             ("f", "FLOAT64", 16), ("q", "FLOAT32", 16), ("i", "INT32", 16),
             ("t", "TIMESTAMP", 16))
    schema = Schema(tuple(Field(n, getattr(DataType, t), str_width=w)
                          for n, t, w in names))
    calls = [C("row_number", None, 1, "rn"), C("rank", None, 1, "rk"),
             C("dense_rank", None, 1, "dr"), C("lag", R(1), 1, "lg"),
             C("lead", R(2), 2, "ld"), C("lag", R(3), 5, "lgf"),
             C("sum", R(1), 1, "sv"), C("count", None, 1, "c"),
             C("avg", R(1), 1, "av"), C("min", R(3), 1, "mnf"),
             C("max", R(1), 1, "mxv"), C("min", R(4), 1, "mnq"),
             C("max", R(5), 1, "mxi"), C("sum", R(3), 1, "s0", (0, 0)),
             C("sum", R(4), 1, "s1", (1, 0)), C("avg", R(5), 1, "a10",
                                                (10, 0))]
    ex = OverWindowExecutor(schema, [R(0)], [(R(5), True), (R(1), False)],
                            calls, pool_size=S, emit_capacity=E)
    st = ex.init_state(device)

    def ints(lo, hi, dtype=torch.int64):
        return torch.randint(lo, hi, (S,), generator=g).to(dtype)

    p = torch.where(torch.rand(S, generator=g) < 0.9, 7, ints(0, 64))
    cols = (p, ints(-20, 20),
            StrCol(torch.randint(0, 256, (S, 6), generator=g,
                                 dtype=torch.uint8),
                   ints(0, 7, torch.int32)),
            ints(-400, 400).to(torch.float64) / 8,
            (ints(-400, 400).to(torch.float32) / 4),
            ints(-9, 9, torch.int32), ints(0, 1 << 40))
    for store, c in zip(st.rows, cols):
        if isinstance(store, StrCol):
            store.data.copy_(c.data)
            store.lens.copy_(c.lens)
        else:
            store.copy_(c)
    st.valid.copy_(torch.rand(S, generator=g) < 0.85)
    return ex, st


#: the K20 cases' pool rows: the partition, an order key with ties, an
#: int64 and a dyadic float64 value, and strings of 3, 16, 40 and 64 bytes
K20_FIELDS = (("p", "INT64", 0), ("k", "INT64", 0), ("v", "INT64", 0),
              ("f", "FLOAT64", 0), ("s3", "VARCHAR", 3),
              ("s16", "VARCHAR", 16), ("s40", "VARCHAR", 40),
              ("s64", "VARCHAR", 64))
#: every call kind, as (kind, argument column, offset, alias, frame):
#: lag/lead within and across the scan's 512-position tiles (offsets 1,
#: 3, 600, 700; strings of 16, 40 and 64 bytes), sums over the whole
#: segment and over ROWS 600 PRECEDING (its first row in an earlier
#: tile), count over ROWS 1 PRECEDING, avg over ROWS 10 PRECEDING
K20_CALLS = (
    ("row_number", None, 1, "rn", None), ("rank", None, 1, "rk", None),
    ("dense_rank", None, 1, "dr", None), ("lag", 2, 1, "lg1", None),
    ("lead", 2, 3, "ld3", None), ("lag", 2, 700, "lg700", None),
    ("lag", 6, 1, "lgs40", None), ("lead", 7, 2, "lds64", None),
    ("lead", 5, 600, "lds16", None), ("sum", 2, 1, "sv", None),
    ("sum", 2, 1, "sv600", (600, 0)), ("count", None, 1, "c1", (1, 0)),
    ("avg", 3, 1, "af10", (10, 0)), ("min", 3, 1, "mnf", None),
    ("max", 2, 1, "mxv", None), ("sum", 3, 1, "sf", None))


def k20_cases() -> list:
    """K20's corner cases, shared with
    ``tests/test_torch_flush_window_grid.py``: dicts with the pool size
    ``S``, the emit capacity ``E``, the pool ``rows`` and ``valid``, and
    ``flip``, the validity flips before a second flush.  Every case runs
    ``K20_CALLS`` partitioned by ``p`` and ordered by ``k`` (ties):
      - ``aligned_partitions``: three partitions of 512 rows, all valid,
        so every segment starts on a tile boundary of the scan (512
        positions) and of the finish (256);
      - ``spanning_partition_overflow``: a partition of 1300 rows over
        three tiles, S > E with more valid rows than E (the overflow
        gauge);
      - ``clamp_e_past_s``: E > S (positions past the pool take row S-1);
      - ``small_ties``: three order values, four partitions, 60% valid.
    Floats are dyadic: the card's sums are exact."""
    import numpy as np

    rng = np.random.default_rng(2020)
    cases = []

    def rows(S, parts, keys):
        cols = [parts.astype(np.int64),
                rng.integers(0, keys, S).astype(np.int64),
                rng.integers(-1000, 1000, S).astype(np.int64),
                (rng.integers(-400, 400, S) / 8.0).astype(np.float64)]
        for _, _, w in K20_FIELDS[4:]:
            cols.append((rng.integers(0, 256, (S, w)).astype(np.uint8),
                         rng.integers(0, w + 1, S).astype(np.int32)))
        return cols

    def case(name, S, E, parts, keys, p_valid):
        cases.append(dict(name=name, S=S, E=E, rows=rows(S, parts, keys),
                          valid=rng.random(S) < p_valid,
                          flip=rng.random(S) < 0.05))

    case("aligned_partitions", 1536, 1536,
         rng.permutation(np.repeat(np.arange(3), 512)), 40, 1.1)
    case("spanning_partition_overflow", 1800, 1500,
         rng.permutation(np.concatenate([np.full(1300, 7),
                                         rng.integers(0, 20, 500)])),
         60, 0.95)
    case("clamp_e_past_s", 700, 1100, rng.integers(0, 5, 700), 30, 0.8)
    case("small_ties", 256, 200, rng.integers(0, 4, 256), 3, 0.6)
    return cases


def k20_schema():
    from risingwave_tpu_torch.common.types import DataType, Field, Schema

    return Schema(tuple(Field(n, getattr(DataType, t), str_width=w or 16)
                        for n, t, w in K20_FIELDS))


def k20_torch_case(torch, case: dict, device):
    """(OverWindowExecutor, TopNState) of a K20 case for the port."""
    from risingwave_tpu_torch.common.chunk import StrCol
    from risingwave_tpu_torch.expr.node import InputRef as R
    from risingwave_tpu_torch.stream.over_window import (
        OverWindowExecutor, WindowFuncCall as C)

    calls = [C(kind, None if arg is None else R(arg), off, alias,
               frame=frame) for kind, arg, off, alias, frame in K20_CALLS]
    ex = OverWindowExecutor(k20_schema(), [R(0)], [(R(1), False)], calls,
                            pool_size=case["S"], emit_capacity=case["E"])
    st = ex.init_state(device)
    for store, c in zip(st.rows, case["rows"]):
        if isinstance(store, StrCol):
            store.data.copy_(torch.from_numpy(c[0]))
            store.lens.copy_(torch.from_numpy(c[1]))
        else:
            store.copy_(torch.from_numpy(c))
    st.valid.copy_(torch.from_numpy(case["valid"]))
    return ex, st


def phase_window_kernels(torch, device, timer, scale):
    """K20 and K19a at q6_bid's shapes (the over-window state of a q6_bid
    engine after 9 barriers: pool 2^18, emitted rows 2^16), K20 exactly
    against its plain version on synthetic pools of every call kind at
    both queries' pool shapes (2^18 / 2^16 and 2^22 / 2^22), K16 timed on
    the over-window's input (the top-N's [2E] flush chunk), and K1/K3 on
    float columns (edge values, and the MV's whole-row key with q6's
    float64 average).  Returns (the kernel entries, extra fields of the
    hash64, probe and topn_pool entries)."""
    from risingwave_tpu_torch.common.chunk import Chunk, NCol
    from risingwave_tpu_torch.common.hash import (
        hash64_columns, hash64_columns_cuda, hash64_columns_plain)
    from risingwave_tpu_torch.common.tree import tree_map
    from risingwave_tpu_torch.state.hash_table import HashTable
    from risingwave_tpu_torch.stream import top_n

    cuda = device.type == "cuda"
    g = torch.Generator(device="cpu").manual_seed(20)
    out, extras = {}, {}

    def flush_pair(ex, st):
        """(kernel flush, plain flush on a CPU copy) of the state, with
        their overflow gauges: (named pairs, kernel result, its state)."""
        a = tree_map(torch.clone, st)
        b = tree_map(lambda t: t.cpu().clone(), st)
        if cuda:
            k = ex.flush_cuda(a)
        else:
            k = ex.flush_plain(a)
            torch.maximum(a.overflow, k[5], out=a.overflow)
            k = k[:5]
        p = ex.flush_plain(b)
        torch.maximum(b.overflow, p[5], out=b.overflow)
        pairs = [(f"over_window {n}", x, y) for (n, x), (_, y)
                 in zip(_flush_planes(torch, k),
                        _flush_planes(torch, p[:5]))]
        pairs.append(("over_window overflow", a.overflow.cpu(), b.overflow))
        return pairs, k, a

    # -- K20 exact on every call kind at both pool shapes ----------------
    shapes = ((1 << 18, 1 << 16), (1 << 22, 1 << 22)) if cuda else \
        ((1 << 12, 1 << 10), (1 << 13, 1 << 13))
    pairs = []
    for S, E in shapes:
        ex, st = _stress_executor(torch, device, S, E, g)
        for step in range(2):
            got, res, a = flush_pair(ex, st)
            pairs += [(f"{n} (pool {S}, flush {step})", x, y)
                      for n, x, y in got]
            # the next flush diffs against these rows; change the pool
            st = st._replace(prev_rows=res[2], prev_valid=res[3],
                             prev_hash=res[4], overflow=a.overflow)
            flip = (torch.rand(S, generator=g) < 0.05).to(device)
            st.valid.logical_xor_(flip)
        print(f"[over_window] exact on {len(ex.calls)} calls of every kind "
              f"at pool {S}, emit {E} ({int(st.valid.sum())} live, "
              f"{int((st.rows[0] == 7).sum())} rows in the hot partition, "
              f"overflow {int(a.overflow)})", flush=True)
        del ex, st, res, a
    # -- K20 on every k20_cases case, two flushes each ------------------
    for case in k20_cases():
        ex, st = k20_torch_case(torch, case, device)
        flip = torch.from_numpy(case["flip"]).to(device)
        for step in range(2):
            got, res, a = flush_pair(ex, st)
            pairs += [(f"{n} ({case['name']}, flush {step})", x, y)
                      for n, x, y in got]
            st = st._replace(prev_rows=res[2], prev_valid=res[3],
                             prev_hash=res[4], overflow=a.overflow)
            st.valid.logical_xor_(flip)
    print(f"[over_window] exact on {len(k20_cases())} edge cases of "
          f"{len(K20_CALLS)} calls, two flushes each", flush=True)
    err = max_abs_err(torch, pairs)
    del pairs

    # -- q6_bid's state: the next barrier through the top-N, then K16 on
    # the over-window's input (the top-N's [2E] flush chunk) ----------------
    eng = _window_engine(torch, device, scale, "q6_bid",
                         WARMUP_BARRIERS if device.type == "cuda" else 1)
    job = eng.jobs[0]
    oi = _executor_index(eng, "OverWindowExecutor")
    tix = _executor_index(eng, "GroupTopNExecutor")
    ow, tex = job.fragment.executors[oi], job.fragment.executors[tix]
    S, E = ow.pool_size, ow.emit_capacity
    tst = tree_map(torch.clone, job.states[tix])
    for c in _topn_inputs(torch, eng, CHUNKS_PER_BARRIER):
        tex.apply(tst, c)
    _, chunk = tex.flush(tst, 0)
    for i in range(tix + 1, oi):
        _, chunk = job.fragment.executors[i].apply((), chunk)
    base = job.states[oi]
    n_del = int((chunk.valid & (chunk.signs() < 0)).sum())
    n_ins = int((chunk.valid & (chunk.signs() > 0)).sum())
    pool_k = top_n.pool_apply_cuda if cuda else \
        (lambda *a: top_n.pool_apply(*a))
    clones = [tree_map(torch.clone, base) for _ in range(6)]
    ms16 = timer(lambda i: pool_k(clones[i].rows, clones[i].valid,
                                  clones[i].row_hash, chunk, S,
                                  clones[i].overflow,
                                  clones[i].inconsistency), 5)
    del clones
    note = "not compared (the plain version's match matrix is too large)"
    ms16_plain = None
    a = tree_map(torch.clone, base)
    pool_k(a.rows, a.valid, a.row_hash, chunk, S, a.overflow,
           a.inconsistency)
    scanned = claimed_prefix(torch, (base.valid, base.row_hash,
                                     base.overflow),
                             (a.valid, a.row_hash, a.overflow), S)
    if n_del * S <= 1 << 30:
        pclones = [tree_map(torch.clone, base) for _ in range(3)]
        ms16_plain = timer(lambda i: top_n.pool_apply_plain(
            pclones[i].rows, pclones[i].valid, pclones[i].row_hash, chunk,
            S), 2)
        del pclones
        b = tree_map(torch.clone, base)
        _, _, _, n_over, n_miss = top_n.pool_apply_plain(
            b.rows, b.valid, b.row_hash, chunk, S)
        b.overflow.add_(n_over)
        b.inconsistency.add_(n_miss)
        max_abs_err(torch, [(f"topn_pool 2E {n}", x, y) for (n, x), (_, y)
                            in zip(_topn_planes("a", a),
                                   _topn_planes("b", b))])
        note = "exact against the plain version"
        del b
    del a
    b16 = pool_apply_bound(chunk.capacity, BID_ROW_BYTES, n_del, n_ins,
                           scanned)
    print(f"[topn_pool] on the over-window's input, the top-N's flush "
          f"chunk of {chunk.capacity} rows ({n_del} deletes, {n_ins} "
          f"inserts) into a pool of {S} ({int(base.valid.sum())} live): "
          f"kernel {ms16:.4f} ms, plain "
          f"{'not measured' if ms16_plain is None else f'{ms16_plain:.4f} ms'}"
          f", bound {b16[0]:.5f} ms; {note}", flush=True)
    extras["topn_pool"] = {"over_window_input": dict(
        rows=chunk.capacity, deletes=n_del, inserts=n_ins, ms=ms16,
        plain_ms=ms16_plain, bound_ms=b16[0], bound_by=b16[1])}
    if cuda:  # the CPU's pool_apply is the plain version itself
        max_abs_err(torch, k16_case_pairs(torch, device, pool_k))
    extras["topn_pool"]["ow_bid_pool"] = phase_k16_ow_bid(torch, device,
                                                          timer, scale)

    # -- K20 on the over-window's state after that chunk ------------------
    st, _ = ow.apply(tree_map(torch.clone, base), chunk)
    got, res, _ = flush_pair(ow, st)
    err = max(err, max_abs_err(torch, got))
    n_live = int(st.valid.sum())
    n_changed = int(res[1].sum())
    if cuda:
        sorted_args = ow.sorted_order_cuda(st)
        ms = timer(lambda i: ow.window_rows_cuda(st, *sorted_args), 20,
                   TOPN_PREFILL_MS)
        flush_ms = timer(lambda i: ow.flush_cuda(st), 10, TOPN_PREFILL_MS)
    else:
        ms = flush_ms = timer(lambda i: ow.flush_plain(st), 1)
    plain_ms = timer(lambda i: ow.flush_plain(st), 3, 4 * TOPN_PREFILL_MS)
    row_in = BID_ROW_BYTES
    row_out = BID_ROW_BYTES + 8
    # scanned positions (P = E): order, valid, partition hash, order key,
    # argument; emitted positions: the pool row and the old row read, the
    # out chunk's two halves and the new row written, hash and liveness
    b20 = bound(E * (8 + 1 + 8 + 8 + 8) + E * row_in + E * row_out
                + 2 * E * row_out + E * row_out + E * 9, E * 60)
    print(f"[over_window] exact on q6_bid's state ({n_live} live rows in "
          f"a pool of {S}, emit {E}, {n_changed} changelog rows); K20 "
          f"{ms:.4f} ms, the whole flush (keys, sorts, K20, membership) "
          f"{flush_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{b20[0]:.5f} ms", flush=True)
    out["over_window"] = kernel_entry(
        "over_window.cu", "risingwave_tpu/stream/over_window.py:169", ms,
        plain_ms, b20, None, err)
    out["over_window"].update(flush_ms=flush_ms, shape=(
        f"pool {S}, emit {E}, {n_live} live, 1 call"))

    # -- K19a: the over-window's clean_below at a third of its date_times
    ts_col = ow.in_schema.index_of("date_time")
    col, pcol = st.rows[ts_col], st.prev_rows[ts_col]
    live_ts = col[st.valid]
    thr = live_ts.kthvalue(max(1, live_ts.numel() // 3)).values
    va, pa = st.valid.clone(), st.prev_valid.clone()
    vb, pb = st.valid.clone(), st.prev_valid.clone()
    clean_k = top_n.clean_below_cuda if cuda else top_n.clean_below_plain
    clean_k(col, va, pcol, pa, thr)
    top_n.clean_below_plain(col, vb, pcol, pb, thr)
    err19 = max_abs_err(torch, [("topn_clean pool", va, vb),
                                ("topn_clean band", pa, pb)])
    n_clean = (int((st.valid != va).sum()), int((st.prev_valid != pa).sum()))
    ms19 = timer(lambda i: clean_k(col, va, pcol, pa, thr), 50)
    plain19 = timer(lambda i: top_n.clean_below_plain(col, vb, pcol, pb,
                                                      thr), 50)
    # read the column (8 B) and flag (1 B) of every pool and band row;
    # write the flags that change
    b19 = bound((S + E) * 9 + sum(n_clean), (S + E) * 2)
    print(f"[topn_clean] exact ({n_live} -> {int(va.sum())} pool rows, "
          f"{int(st.prev_valid.sum())} -> {int(pa.sum())} emitted rows of "
          f"{S} + {E}); kernel {ms19:.4f} ms, plain (the two-op mask "
          f"expression) {plain19:.4f} ms, bound {b19[0]:.5f} ms", flush=True)
    out["topn_clean"] = kernel_entry(
        "topn_clean.cu", "risingwave_tpu/stream/top_n.py:418", ms19,
        plain19, b19, plain19, err19)

    # -- K1 and K3 on float columns ----------------------------------------
    n = 8192 // scale
    fmin = float(torch.finfo(torch.float32).tiny)
    edges = torch.tensor([0.0, -0.0, float("nan"), -float("nan"),
                          float("inf"), -float("inf"), 1e-40, -1e-40,
                          1e-310, -1e-310, 1.5e-38 + 1e-45, 1.0 + 2 ** -60,
                          3.4e38 * 1.0000001, 1e300, fmin * (1 - 2 ** -30),
                          -fmin * (1 - 2 ** -30), fmin * (1 - 2 ** -20),
                          2.5], dtype=torch.float64)
    x = torch.randn(n, generator=g, dtype=torch.float64) * 10.0 ** \
        torch.randint(-45, 45, (n,), generator=g).to(torch.float64)
    x[: 4 * edges.numel()] = edges.repeat(4)
    null = torch.rand(n, generator=g) < 0.2
    fcols = [x.to(device), x.to(torch.float32).to(device),
             NCol(x.to(device), null.to(device))]
    hk = hash64_columns_cuda(fcols)[0] if cuda else \
        hash64_columns_plain(fcols)
    errf = max_abs_err(torch, [("hash64 floats", hk,
                                hash64_columns_plain(fcols))])
    hfn = (lambda i: hash64_columns_cuda(fcols)) if cuda else \
        (lambda i: hash64_columns_plain(fcols))
    hf_ms = timer(hfn, 200)
    hf_plain = timer(lambda i: hash64_columns_plain(fcols), 20,
                     TOPN_PREFILL_MS)
    # per row: 8 + 4 + 8 + 1 B read, 8 B written; 5 words folded
    bh = bound(n * 29, n * 5 * 12)
    print(f"[hash64] exact on {n} float rows (float64, float32, nullable "
          f"float64; -0.0, NaNs, infinities, subnormals); kernel "
          f"{hf_ms:.4f} ms, plain {hf_plain:.4f} ms, bound {bh[0]:.5f} ms",
          flush=True)
    extras["hash64"] = {"floats": dict(
        shape=f"{n} rows: float64, float32, nullable float64", ms=hf_ms,
        plain_ms=hf_plain, bound_ms=bh[0], bound_by=bh[1],
        max_abs_err=errf)}

    # K3: float64 edge keys into a small table (insert, then a lookup of
    # -0.0 for +0.0 and subnormals for zero), then the MV's whole-row key
    def probe_pairs(tag, ta, tb, keys, valid, insert):
        ra = ta._probe_cuda(keys, valid, insert) if cuda else \
            ta._probe_plain(keys, valid, insert)
        rb = tb._probe_plain(keys, valid, insert)
        pairs = [(f"{tag} {nm}", x, y) for nm, x, y in zip(
            ("slots", "found", "overflow", "n_over"), ra[1:], rb[1:])]
        pairs += [(f"{tag} occupied", ta.occupied, tb.occupied)]
        for j, (x, y) in enumerate(zip(ta.key_cols, tb.key_cols)):
            if not isinstance(x, torch.Tensor):
                continue
            if x.dtype.is_floating_point:
                x, y = x.view(torch.int64 if x.element_size() == 8
                              else torch.int32), \
                    y.view(torch.int64 if y.element_size() == 8
                           else torch.int32)
            pairs.append((f"{tag} key {j}", x, y))
        return pairs, ra

    keys = [torch.cat([edges, edges, x[:1000]]).to(device)]
    valid = torch.ones(keys[0].shape[0], dtype=torch.bool, device=device)
    ta = HashTable.create([torch.zeros(1, dtype=torch.float64)], 1 << 12,
                          device)
    tb = ta.clone()
    pairs, _ = probe_pairs("probe float64 insert", ta, tb, keys, valid,
                           True)
    # -0.0 for +0.0, +0.0 for -0.0, and a float64 subnormal for 1e-310
    look = edges.clone()
    look[0], look[1], look[8] = -0.0, 0.0, -2e-310
    p2, _ = probe_pairs("probe float64 lookup", ta, tb,
                        [look.to(device)],
                        torch.ones(look.numel(), dtype=torch.bool,
                                   device=device), False)
    pairs += p2
    mi = len(job.fragment.executors) - 1
    mex, mv = job.fragment.executors[mi], job.states[mi]
    outc = Chunk(res[0], ow._ops_for(device), res[1], ow.out_schema)
    for i in range(oi + 1, mi):
        _, outc = job.fragment.executors[i].apply((), outc)
    mkeys = [outc.column(i) for i in mex.pk_indices]
    pm, _ = probe_pairs("probe q6 MV key", mv.table.clone(),
                        mv.table.clone(), mkeys, outc.valid, True)
    errp = max_abs_err(torch, pairs + pm)
    tl = mv.table.clone()
    # K3 alone: the hashes (K1) computed before the timed calls
    hk = hash64_columns(mkeys)
    pfn = (lambda i: tl._probe_cuda(mkeys, outc.valid, False, hk)) if cuda \
        else (lambda i: tl._probe_plain(mkeys, outc.valid, False))
    p_ms = timer(pfn, 20)
    p_plain = timer(lambda i: tl._probe_plain(mkeys, outc.valid, False), 3,
                    4 * TOPN_PREFILL_MS)
    nrow = outc.capacity
    vis = int(outc.valid.sum())
    bp = probe_bound(nrow, vis, 0, 32)
    print(f"[probe] exact on float64 edge keys (NaN finds nothing, -0.0 "
          f"finds +0.0, subnormals find zero) and on q6_bid's MV key "
          f"(bidder, price, date_time, float64 avg): {vis} visible of "
          f"{nrow} rows into {mv.table.size}; kernel {p_ms:.4f} ms, plain "
          f"{p_plain:.4f} ms, bound {bp[0]:.5f} ms", flush=True)
    extras["probe"] = {"floats": dict(
        shape=f"{nrow} rows ({vis} visible), 4 key columns with a float64 "
        f"into {mv.table.size}", ms=p_ms, plain_ms=p_plain,
        bound_ms=bp[0], bound_by=bp[1], max_abs_err=errp)}
    del eng, st, base, res, tl, outc, chunk
    if cuda:
        torch.cuda.empty_cache()
    return out, extras


#: live rows of ow_bid's over-window pool at the end of its bench run
OW_BID_LIVE = 2_818_048


def k16_ow_bid_shape(torch, device, scale: int, seed: int = 61):
    """ow_bid's K16 call: an 8192-bid chunk of fresh inserts into the
    over-window's 2^22-slot pool of whole bid rows (4 int64 columns, a
    16-byte channel, a 40-byte url) with ``OW_BID_LIVE`` live rows as a
    prefix, as the append-only run leaves it.  Returns (pool, chunk, S,
    live): pool as ``k16_torch_case`` makes it."""
    import numpy as np

    from risingwave_tpu_torch.common.chunk import Chunk, StrCol
    from risingwave_tpu_torch.common.types import DataType, Field, Schema

    S, cap, live = (1 << 22) // scale, 8192 // scale, OW_BID_LIVE // scale
    schema = Schema((Field("auction", DataType.INT64),
                     Field("bidder", DataType.INT64),
                     Field("price", DataType.INT64),
                     Field("channel", DataType.VARCHAR, str_width=16),
                     Field("url", DataType.VARCHAR, str_width=40),
                     Field("date_time", DataType.TIMESTAMP)))
    rng = np.random.default_rng(seed)

    def col(f, n):
        if f.data_type == DataType.VARCHAR:
            w = f.str_width
            return StrCol(torch.from_numpy(rng.integers(
                0, 256, (n, w)).astype(np.uint8)).to(device),
                torch.from_numpy(rng.integers(0, w + 1, n)
                                 .astype(np.int32)).to(device))
        return torch.from_numpy(rng.integers(0, 1 << 40, n)).to(device)

    chunk = Chunk(tuple(col(f, cap) for f in schema),
                  torch.zeros(cap, dtype=torch.int8, device=device),
                  torch.ones(cap, dtype=torch.bool, device=device), schema)
    rows = tuple(StrCol(torch.zeros((S, c.data.shape[1]), dtype=torch.uint8,
                                    device=device),
                        torch.zeros(S, dtype=torch.int32, device=device))
                 if isinstance(c, StrCol) else
                 torch.zeros(S, dtype=torch.int64, device=device)
                 for c in chunk.columns)
    valid = torch.zeros(S, dtype=torch.bool, device=device)
    valid[:live] = True
    i64 = dict(dtype=torch.int64, device=device)
    pool = (rows, valid, torch.zeros(S, **i64), torch.zeros((), **i64),
            torch.zeros((), **i64))
    return pool, chunk, S, live


def phase_k16_ow_bid(torch, device, timer, scale) -> dict:
    """K16 at ow_bid's shape (``k16_ow_bid_shape``), exactly against its
    plain version, both timed; each timed call starts from the prefix of
    ``OW_BID_LIVE`` live rows (the validity is reset between calls)."""
    from risingwave_tpu_torch.common.tree import tree_map
    from risingwave_tpu_torch.stream import top_n

    cuda = device.type == "cuda"
    kernel = top_n.pool_apply_cuda if cuda else \
        (lambda *a: top_n.pool_apply(*a))
    pool, chunk, S, live = k16_ow_bid_shape(torch, device, scale)
    b = tree_map(torch.clone, pool)
    kernel(*pool[:3], chunk, S, *pool[3:])
    # the validity the inserts need read: the live prefix and the chunk's
    # claims after it (live + cap slots), not the whole pool
    scanned = claimed_prefix(torch, (b[1], b[2], b[3]), pool[1:4], S)
    *_, n_over, n_miss = top_n.pool_apply_plain(*b[:3], chunk, S)
    b[3].add_(n_over)
    b[4].add_(n_miss)
    err = max_abs_err(torch, _pool_pairs("topn_pool ow_bid", pool, b))
    del b

    def call(fn):
        def run(i):
            pool[1][live:].zero_()
            fn(*pool[:3], chunk, S, *pool[3:])
        return run

    ms = timer(call(kernel), 20)
    plain_ms = timer(call(lambda *a: top_n.pool_apply_plain(*a[:5])), 3)
    cap = chunk.capacity
    bb = pool_apply_bound(cap, BID_ROW_BYTES, 0, cap, scanned)
    print(f"[topn_pool] at ow_bid's shape ({cap} bids into a pool of {S} "
          f"with {live} live): exact; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms (the reset of the validity included in "
          f"both), bound {bb[0]:.5f} ms (validity read over {scanned} "
          f"slots)", flush=True)
    return dict(rows=cap, pool=S, live=live, ms=ms, plain_ms=plain_ms,
                bound_ms=bb[0], bound_by=bb[1], scanned=scanned,
                max_abs_err=err)


def k18_ow_bid_shape(torch, device, scale: int, seed: int = 181):
    """K18's membership at ow_bid's shape: two sides of 2^22 entries (the
    emitted rows and the new rows of the over-window's flush), the old
    side ``OW_BID_LIVE`` live rows with random hashes as a prefix (dead
    entries hash 0), the new side the same rows with ~1% of the live
    hashes changed and 8192 more live rows after them.  Returns
    (prev_hash, prev_valid, cur_hash, cur_live, changed)."""
    import numpy as np

    E, live = (1 << 22) // scale, OW_BID_LIVE // scale
    rng = np.random.default_rng(seed)
    prev = np.zeros(E, np.int64)
    prev[:live] = rng.integers(-2**63, 2**63 - 1, live, dtype=np.int64)
    cur = prev.copy()
    changed = rng.random(live) < 0.01
    cur[:live][changed] = rng.integers(-2**63, 2**63 - 1, int(changed.sum()),
                                       dtype=np.int64)
    more = min(8192 // scale, E - live)
    cur[live:live + more] = rng.integers(-2**63, 2**63 - 1, more,
                                         dtype=np.int64)
    pv = np.arange(E) < live
    cv = np.arange(E) < live + more

    def t(a):
        return torch.from_numpy(a).to(device)

    return t(prev), t(pv), t(cur), t(cv), int(changed.sum()) + more


#: K18's membership kernels (profiler names)
K18_DIFF_KERNELS = ("topn_flush_scan_kernel", "topn_flush_member_kernel")
#: K20's two kernels
K20_KERNELS = ("ow_scan", "ow_finish")
#: K18's three kernels
K18_KERNELS = ("topn_flush_gather_kernel",) + K18_DIFF_KERNELS
#: the prefix of torch.sort's radix-sort kernels (CUB's) by the profiler
RADIX_SORT = "at_cuda_detail::cub::DeviceRadixSort"


def phase_k18_ow_bid(torch, device, timer, scale) -> dict:
    """K18's membership (``band_membership_cuda``: the two sorts, the run
    scan and the merge) at ow_bid's shape (``k18_ow_bid_shape``), exactly
    against ``band_membership_plain``, both timed, and its two kernels'
    device time read by the profiler."""
    from risingwave_tpu_torch.stream import top_n

    cuda = device.type == "cuda"
    kernel = top_n.band_membership_cuda if cuda else \
        top_n.band_membership_plain
    args = k18_ow_bid_shape(torch, device, scale)
    sides, changed = args[:4], args[4]
    got = kernel(*sides)
    want = top_n.band_membership_plain(*sides)
    err = max_abs_err(torch, [("topn_flush membership at ow_bid", got,
                               want)])
    n_out = int(got.sum())
    ms = timer(lambda i: kernel(*sides), 10, 4.0)
    plain_ms = timer(lambda i: top_n.band_membership_plain(*sides), 3, 20.0)
    split = device_ms_by_kernel(torch, device, lambda i: kernel(*sides), 5,
                                K18_DIFF_KERNELS)
    E = sides[0].shape[0]
    # after the sorts: each side's sorted hashes, permutation and live
    # flags read once, the 2E flags written
    b = bound(2 * E * (8 + 8 + 1) + 2 * E, 2 * E * 20)
    kern = "" if split is None else (
        f", its kernels {sum(split.values()):.4f} ms by the profiler (scan "
        f"{split[K18_DIFF_KERNELS[0]]:.4f}, merge "
        f"{split[K18_DIFF_KERNELS[1]]:.4f})")
    print(f"[topn_flush] membership at ow_bid's shape (2 x {E} entries, "
          f"{int(sides[1].sum())} -> {int(sides[3].sum())} live, {changed} "
          f"changed or new: {n_out} out): exact; the call (two sorts "
          f"included) {ms:.4f} ms{kern}, plain {plain_ms:.4f} ms, bound "
          f"{b[0]:.5f} ms", flush=True)
    out = dict(entries=E, live=int(sides[3].sum()), changed=changed,
               out_rows=n_out, ms=ms, plain_ms=plain_ms, bound_ms=b[0],
               bound_by=b[1], max_abs_err=err)
    if split is not None:
        out.update(scan_ms=split[K18_DIFF_KERNELS[0]],
                   merge_ms=split[K18_DIFF_KERNELS[1]])
    return out


def phase_window_parity(torch, device, query: str) -> None:
    """``query`` at 2 events/s through the engine on ``device`` and on
    the CPU (plain versions), chunk 256, 10 barriers of 4 chunks: MV rows
    and every state tensor (both pools, the emitted rows with their
    float64 averages, the MV) must be equal."""
    from risingwave_tpu_torch.compat import state_mismatches, state_to_numpy
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig

    size = 4096 if query == "q6_bid" else 16384
    cfg = PlannerConfig(chunk_capacity=256, topn_pool_size=size,
                        topn_emit_capacity=size // 4 if query == "q6_bid"
                        else size, mv_table_size=1 << 15)
    engines = []
    for dev in (device, torch.device("cpu")):
        eng = Engine(cfg, device=dev)
        eng.execute(BENCH_SOURCES.replace("'1000000'", "'2'"))
        eng.execute(QUERY_SQL[query])
        eng.tick(barriers=10, chunks_per_barrier=4)
        engines.append(eng)
    rows = [sorted(tuple(_host_value(v) for v in r) for r in e.execute(
        "SELECT * FROM bench_mv")) for e in engines]
    if rows[0] != rows[1] or not rows[0]:
        fail(f"{query} MV on the card differs from the CPU plain versions")
    bad = state_mismatches(state_to_numpy(engines[1].jobs[0].states),
                           engines[0].jobs[0].states)
    if bad:
        fail(f"{query} state on the card differs from the CPU: {bad[:5]}")
    st = engines[0].jobs[0].states[_executor_index(engines[0],
                                                   "OverWindowExecutor")]
    print(f"[parity] {query} at 2 events/s, 10 barriers: {len(rows[0])} MV "
          f"rows and all state equal to the CPU plain versions "
          f"(over-window pool {int(st.valid.sum())} rows, emitted "
          f"{int(st.prev_valid.sum())}, overflow {int(st.overflow)})",
          flush=True)


def _mv_columns(eng):
    """The MV's rows as numpy columns by name, read from its table (one
    row per occupied slot)."""
    job = eng.jobs[0]
    mi = len(job.fragment.executors) - 1
    mex, mv = job.fragment.executors[mi], job.states[mi]
    occ = mv.table.occupied
    return {f.name: v[occ].cpu().numpy()
            for f, v in zip(mex.out_schema, mv.values)}


def _rows_as_bids(bids, mv):
    """Positions of the MV's rows among the consumed bids (by date_time,
    unique at 1M events/s), each required to be that bid."""
    import numpy as np

    ts = bids["ts"]
    if np.unique(ts).shape[0] != ts.shape[0]:
        fail("consumed bids share a date_time: the MV check needs them "
             "unique")
    order = np.argsort(ts, kind="stable")
    pos = order[np.clip(np.searchsorted(ts[order], mv["date_time"]), 0,
                        ts.size - 1)]
    if not (np.array_equal(ts[pos], mv["date_time"])
            and np.array_equal(bids["bidder"][pos], mv["bidder"])
            and np.array_equal(bids["price"][pos], mv["price"])):
        fail("an MV row is not a consumed bid")
    return pos


def _segment_starts_np(keys):
    import numpy as np

    first = np.r_[True, keys[1:] != keys[:-1]]
    return np.maximum.accumulate(np.where(first, np.arange(keys.size), 0))


def check_q6_bid(eng, bids) -> str:
    """One MV row per auction, the bid with the auction's highest price;
    per bidder, in date_time order, avg is the mean price of the row and
    the 10 rows before it."""
    import numpy as np

    mv = _mv_columns(eng)
    pos = _rows_as_bids(bids, mv)
    auc, price = bids["auction"], bids["price"]
    got_auc = auc[pos]
    all_auc = np.unique(auc)
    if not np.array_equal(np.sort(got_auc), all_auc):
        fail(f"q6_bid MV holds {got_auc.size} rows for {all_auc.size} "
             "auctions, not one per auction")
    o = np.argsort(auc, kind="stable")
    seg = np.r_[True, auc[o][1:] != auc[o][:-1]]
    top = np.maximum.reduceat(price[o], np.flatnonzero(seg))
    if not np.array_equal(mv["price"], top[np.searchsorted(all_auc,
                                                           got_auc)]):
        fail("a q6_bid MV row is not its auction's highest bid")
    o = np.lexsort((mv["date_time"], mv["bidder"]))
    p_s = mv["price"][o]
    start = _segment_starts_np(mv["bidder"][o])
    idx = np.arange(o.size)
    lo = np.maximum(idx - 10, start)
    cs = np.cumsum(p_s)
    want = (cs - cs[lo] + p_s[lo]).astype(np.float64) / (idx - lo + 1)
    if not np.array_equal(mv["avg"][o], want):
        bad = int((mv["avg"][o] != want).sum())
        fail(f"q6_bid avg differs from numpy's 11-row moving average on "
             f"{bad} rows")
    return (f"MV equals numpy's top-1 bid of each of {all_auc.size} "
            f"auctions over {auc.size} bids, with each bidder's 11-row "
            f"moving average (exact in float64) over "
            f"{np.unique(mv['bidder']).size} bidders")


def check_ow_bid(eng, bids) -> str:
    """One MV row per consumed bid; per auction in date_time order:
    row_number = rank = dense_rank = position + 1 (date_times are
    unique), lag/lead the neighbouring prices (0 at the ends), running
    max, sum and count."""
    import numpy as np

    mv = _mv_columns(eng)
    n = bids["ts"].size
    if mv["date_time"].size != n:
        fail(f"ow_bid MV holds {mv['date_time'].size} rows for {n} bids")
    pos = _rows_as_bids(bids, mv)
    if np.unique(pos).size != n:
        fail("ow_bid MV rows repeat a bid")
    auc, price, ts = bids["auction"], bids["price"], bids["ts"]
    o = np.lexsort((ts, auc))
    a_s, p_s = auc[o], price[o]
    start = _segment_starts_np(a_s)
    idx = np.arange(n)
    rn = idx - start + 1
    first = rn == 1
    last = np.r_[a_s[1:] != a_s[:-1], True]
    prev = np.where(first, 0, np.r_[0, p_s[:-1]])
    nxt = np.where(last, 0, np.r_[p_s[1:], 0])
    seg_id = np.cumsum(first)
    big = seg_id.astype(np.int64) << 40
    mx = np.maximum.accumulate(p_s + big) - big
    cs = np.cumsum(p_s)
    sm = cs - cs[start] + p_s[start]
    inv = np.empty(n, np.int64)
    inv[o] = idx                      # bid -> its sorted position
    at = inv[pos]                     # MV row -> sorted position
    want = {"rn": rn, "rk": rn, "drk": rn, "prev_price": prev,
            "next_price": nxt, "max_so_far": mx, "sum_so_far": sm,
            "n_so_far": rn}
    for name, w in want.items():
        if not np.array_equal(mv[name], w[at]):
            bad = int((mv[name] != w[at]).sum())
            fail(f"ow_bid {name} differs from numpy on {bad} rows")
    if not np.array_equal(mv["auction"], auc[pos]):
        fail("an ow_bid MV row's auction is not its bid's")
    return (f"MV equals numpy's per-auction row_number, rank, dense_rank, "
            f"lag, lead, running max, sum and count over {n} bids "
            f"({np.unique(auc).size} auctions, the largest holding "
            f"{int(np.bincount(seg_id).max())} bids)")


def _capture_mv_probe(torch, eng, job):
    """Run one barrier and keep the inputs of the MV's largest probe in
    it: a copy of the MV's table before the call, the key columns and the
    valid flags."""
    from risingwave_tpu_torch.state.hash_table import HashTable

    mv = job.fragment.executors[_executor_index(eng, "MaterializeExecutor")]
    orig = HashTable.lookup_or_insert
    seen = {}

    def capturing(self, key_cols, valid, hashes=None):
        if self.size == mv.table_size and valid.shape[0] >= seen.get(
                "cap", 0):
            seen.update(cap=valid.shape[0], table=self.clone(),
                        cols=[c.clone() for c in key_cols],
                        valid=valid.clone())
        return orig(self, key_cols, valid, hashes)

    HashTable.lookup_or_insert = capturing
    try:
        eng.tick(barriers=1, chunks_per_barrier=CHUNKS_PER_BARRIER)
    finally:
        HashTable.lookup_or_insert = orig
    if "table" not in seen:
        fail("ow_bid: the MV's probe was not called in a barrier")
    return seen


def _time_mv_probe(torch, device, cap_in) -> dict:
    """K3 at ow_bid's shape: the captured MV probe against its plain
    version on copies of the table (exact), then timed with its hashes
    (K1, timed apart) computed before the calls, and its kernels' device
    time read by the profiler."""
    from risingwave_tpu_torch.common.hash import hash64_columns, key_leaves
    from risingwave_tpu_torch.state import hash_table as ht

    base, cols, valid = cap_in["table"], cap_in["cols"], cap_in["valid"]
    cap, size = valid.shape[0], base.size
    tk, tp = base.clone(), base.clone()
    rk = tk._probe(cols, valid, True)
    rp = tp._probe_plain(cols, valid, True)
    stats = _check_probe_path(torch, device, ht, "default", True)
    max_abs_err(torch, [(x[0], x[1], y[1]) for x, y in
                        zip(_probe_planes(torch, "probe at ow_bid", rk, tk),
                            _probe_planes(torch, "probe at ow_bid", rp,
                                          tp))])
    n_valid, n_ins = int(valid.sum()), int(rp[2].sum())
    del tk, tp, rk, rp
    timer = Timer(torch, device)
    n_it = 5 if device.type == "cuda" else 1
    h = hash64_columns(cols)
    hash_ms = timer(lambda i: hash64_columns(cols), n_it, 20.0)
    clones = [base.clone() for _ in range(n_it + 1)]
    ms = timer(lambda i: clones[i]._probe(cols, valid, True, h), n_it, 20.0)
    del clones
    clones = [base.clone() for _ in range(n_it + 1)]
    split = device_ms_by_kernel(
        torch, device, lambda i: clones[i]._probe(cols, valid, True, h),
        n_it, PROBE_KERNELS)
    del clones
    pc = [base.clone() for _ in range(2)]
    plain_ms = timer(lambda i: pc[i]._probe_plain(cols, valid, True), 1,
                     200.0)
    del pc
    kw = sum(d.element_size() * (d.shape[1] if d.dim() > 1 else 1)
             for d, _, _ in key_leaves(cols))
    b = probe_bound(cap, n_valid, n_ins, kw)
    rounds = "" if stats is None else (
        f"; {stats[0]} claimants, {stats[1]} grid and {stats[2]} one-block "
        "rounds")
    by_kernel = "" if split is None else (
        f" (device time walk {split['probe_walk']:.4f} + rounds "
        f"{split['probe_claim']:.4f} ms)")
    print(f"[probe] exact at ow_bid's shape (the MV's probe of a "
          f"{cap}-row flush chunk of {kw}-byte keys, {n_valid} valid, "
          f"{n_ins} inserted, into {size} slots{rounds}); K1's hashes "
          f"apart ({hash_ms:.4f} ms): kernel {ms:.4f} ms{by_kernel}, plain "
          f"{plain_ms:.4f} ms, bound {b[0]:.5f} ms", flush=True)
    out = dict(cap=cap, valid=n_valid, inserted=n_ins, size=size,
               key_bytes=kw, ms=ms, hash_ms=hash_ms, plain_ms=plain_ms,
               bound_ms=b[0], bound_by=b[1])
    if split is not None:
        out.update(walk_ms=split["probe_walk"],
                   claim_ms=split["probe_claim"])
    if stats is not None:
        out.update(claimants=stats[0], grid_rounds=stats[1],
                   block_rounds=stats[2])
    return out


def phase_window_main_path(torch, device, scale, query: str):
    """q6_bid or ow_bid at the slice's sizes: 9 warm-up barriers, then 32
    timed barriers of 8 chunks with the launch counters; the live rows of
    the over-window (and q6_bid's top-N band) recorded at every flush
    (within the emitted capacity: lossless), the counters audited, the
    MV checked with numpy.  ow_bid's K20 and whole flush are timed on its
    final state (pool 2^22)."""
    from risingwave_tpu_torch import kernels

    eng = _window_engine(torch, device, scale, query, 0)
    job = eng.jobs[0]
    oi = _executor_index(eng, "OverWindowExecutor")
    ow = job.fragment.executors[oi]
    live = []
    ow_flush = ow.flush

    def recorded(state, epoch):
        live.append(state.valid.sum())
        return ow_flush(state, epoch)

    ow.flush = recorded
    bands = []
    if query == "q6_bid":
        tex = job.fragment.executors[_executor_index(eng,
                                                     "GroupTopNExecutor")]
        band_mask = tex._band_mask

        def banded(state):
            band, ranks = band_mask(state)
            bands.append(band.sum())
            return band, ranks

        tex._band_mask = banded
    warmup = WARMUP_BARRIERS if device.type == "cuda" else 1
    if query == "ow_bid":
        # the MV's probe of the last warm-up barrier's flush chunk, read
        # from the path: K3 at ow_bid's shape, timed after the run
        eng.tick(barriers=warmup - 1, chunks_per_barrier=CHUNKS_PER_BARRIER)
        mv_probe = _capture_mv_probe(torch, eng, job)
    else:
        eng.tick(barriers=warmup, chunks_per_barrier=CHUNKS_PER_BARRIER)
    if device.type == "cuda":
        torch.cuda.synchronize()
    kernels.reset_launches()
    barriers = BARRIERS if device.type == "cuda" else 2
    t0 = time.perf_counter()
    eng.tick(barriers=barriers, chunks_per_barrier=CHUNKS_PER_BARRIER)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    cap = job.source.cap
    chunks = barriers * CHUNKS_PER_BARRIER
    rows = chunks * cap
    rate = rows / dt
    port = sum(launches.values())
    print(f"[main] {query} {rows} rows in {dt:.3f} s = {rate:.0f} rows/s; "
          f"port kernel launches {port / chunks:.2f} per chunk {launches}",
          flush=True)
    if device.type == "cuda":
        per_chunk = profile_window(torch, eng, query)
        print(f"[main] {query} launches per chunk "
              f"{'not measured' if per_chunk is None else f'{per_chunk:.1f}'}"
              f" (all CUDA kernels, profiled window)", flush=True)
    eng.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1")
    try:
        eng.tick(barriers=1, chunks_per_barrier=0)
    except RuntimeError as e:
        fail(f"{query}: the counter audit raised: {e}")
    st = job.states[oi]
    E = ow.emit_capacity
    peak = int(torch.stack(live).max())
    counters = [int(s.overflow) for s in job.states if hasattr(s, "overflow")]
    counters += [int(s.inconsistency) for s in job.states
                 if hasattr(s, "inconsistency")]
    late = int(job.states[0].late_rows)
    if any(counters) or late or peak > E:
        fail(f"{query}: overflow/inconsistency counters {counters}, late "
             f"rows {late}, largest over-window pool {peak} of emitted "
             f"capacity {E}")
    msg = (f"over-window pool at each of {len(live)} flushes <= {E} "
           f"(largest {peak})")
    if bands:
        top = int(torch.stack(bands).max())
        if top > tex.emit_capacity:
            fail(f"{query}: the top-N band reached {top} of "
                 f"{tex.emit_capacity}")
        msg += f", top-N band <= {tex.emit_capacity} (largest {top})"
    print(f"[check] {query} overflow and inconsistency counters 0, no late "
          f"rows; {msg}: lossless", flush=True)
    bids = _consumed_bids_full(eng, cap)
    check = {"q6_bid": check_q6_bid, "ow_bid": check_ow_bid}[query]
    print(f"[check] {query} {check(eng, bids)}", flush=True)
    info = dict(pool=ow.pool_size, emit=E, live=int(st.valid.sum()))
    if query == "ow_bid":
        S = ow.pool_size
        if device.type == "cuda":
            timer = Timer(torch, device)
            sorted_args = ow.sorted_order_cuda(st)
            info["ms"] = timer(lambda i: ow.window_rows_cuda(
                st, *sorted_args), 5, 20.0)
            info["sort_ms"] = timer(lambda i: ow.sorted_order_cuda(st), 5,
                                    20.0)
            info["flush_ms"] = timer(lambda i: ow.flush_cuda(st), 3, 40.0)
            info["plain_ms"] = timer(lambda i: ow.flush_plain(st), 1, 200.0)
            split = device_ms_by_kernel(
                torch, device, lambda i: ow.flush_cuda(st), 3,
                K20_KERNELS + K18_DIFF_KERNELS + (RADIX_SORT,))
            if split is not None:
                info["flush_device_ms_by_kernel"] = split
        # per position: order, valid, hash, order key, the sum/max
        # arguments, 5 lanes; per row the pool row and old row read, the
        # out chunk's halves and the new row written
        row_out = BID_ROW_BYTES + 8 * 8
        b = bound(S * (8 + 1 + 8 + 8 + 16) + S * BID_ROW_BYTES
                  + S * row_out + 3 * S * row_out + 9 * S, S * 200)
        info.update(bound_ms=b[0], bound_by=b[1])
        times = "not timed in a rehearsal" if "ms" not in info else (
            f"K20 {info['ms']:.4f} ms, the key launch and sorts "
            f"{info['sort_ms']:.4f} ms, the whole flush "
            f"{info['flush_ms']:.4f} ms, plain {info['plain_ms']:.4f} ms")
        if "flush_device_ms_by_kernel" in info:
            times += " (the flush's device time: " + ", ".join(
                f"{k.split('::')[-1]} {v:.4f}" for k, v in
                info["flush_device_ms_by_kernel"].items()) + " ms)"
        print(f"[over_window] ow_bid's flush at pool {S} ({info['live']} "
              f"live rows): {times}, bound {b[0]:.5f} ms", flush=True)
        info["probe"] = _time_mv_probe(torch, device, mv_probe)
        del mv_probe
    del eng, st
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return launches, rate, info


def phase_window_clean_path(torch, device, scale):
    """q6_bid with the over-window's watermark cleaning set on the
    executor (its input's date_time, lag 2 s): no reference plan sets it,
    so this path is built at the executor level.  9 warm-up barriers,
    then 8 barriers with the launch counters; afterwards no live pool or
    emitted row lies below the last threshold."""
    from risingwave_tpu_torch import kernels
    from risingwave_tpu_torch.stream.fragment import WM_NONE

    eng = _window_engine(torch, device, scale, "q6_bid", 0)
    job = eng.jobs[0]
    oi = _executor_index(eng, "OverWindowExecutor")
    ow = job.fragment.executors[oi]
    ts_col = ow.in_schema.index_of("date_time")
    ow.watermark_col_idx, ow.watermark_lag = ts_col, CLEAN_LAG_US
    eng.tick(barriers=WARMUP_BARRIERS if device.type == "cuda" else 1,
             chunks_per_barrier=CHUNKS_PER_BARRIER)
    if device.type == "cuda":
        torch.cuda.synchronize()
    kernels.reset_launches()
    barriers = 8
    t0 = time.perf_counter()
    eng.tick(barriers=barriers, chunks_per_barrier=CHUNKS_PER_BARRIER)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    rows = barriers * CHUNKS_PER_BARRIER * job.source.cap
    wm = job.states[0].max_ts
    if int(wm) == WM_NONE:
        fail("q6_bid clean: no watermark was generated")
    thr = int(wm) - job.fragment.executors[0].delay_us - CLEAN_LAG_US
    st = job.states[oi]
    low = int((st.valid & (st.rows[ts_col] < thr)).sum()) + int(
        (st.prev_valid & (st.prev_rows[ts_col] < thr)).sum())
    if low or int(st.overflow) or int(st.inconsistency):
        fail(f"q6_bid clean: {low} live rows below the threshold, overflow "
             f"{int(st.overflow)}, inconsistency {int(st.inconsistency)}")
    print(f"[main] q6_bid clean {rows} rows in {dt:.3f} s = {rows / dt:.0f} "
          f"rows/s; the over-window keeps {int(st.valid.sum())} pool rows "
          f"and {int(st.prev_valid.sum())} emitted rows, none below the "
          f"threshold; port kernel launches {launches}", flush=True)
    del eng, st
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return launches, rows / dt


# ---------------------------------------------------------------------------
# q101, q103, q104: the join matrix on retractable inputs (K13d, K14 over
# dense builds with pads and semi/anti rows, the agg's spill capture)


#: bench.py's bid source and its auction source with item_name and category
JOIN_SOURCES = """
CREATE SOURCE bid (
    auction BIGINT, bidder BIGINT, price BIGINT,
    channel VARCHAR, url VARCHAR, date_time TIMESTAMP,
    WATERMARK FOR date_time AS date_time - INTERVAL '4' SECOND
) WITH (connector = 'nexmark', nexmark.table = 'bid',
        nexmark.event.rate = '1000000');
CREATE SOURCE auction (
    id BIGINT, item_name VARCHAR, seller BIGINT, reserve BIGINT,
    expires TIMESTAMP, date_time TIMESTAMP, category BIGINT,
    WATERMARK FOR date_time AS date_time - INTERVAL '4' SECOND
) WITH (connector = 'nexmark', nexmark.table = 'auction',
        nexmark.event.rate = '1000000');
"""
#: RisingWave's Nexmark q101, q103, q104 and q102, as published
JOIN_QUERY_SQL = {
    "q101": """
CREATE MATERIALIZED VIEW nexmark_q101 AS
SELECT
    a.id AS auction_id,
    a.item_name AS auction_item_name,
    b.max_price AS current_highest_bid
FROM auction a
LEFT OUTER JOIN (
    SELECT
        b1.auction,
        MAX(b1.price) max_price
    FROM bid b1
    GROUP BY b1.auction
) b ON a.id = b.auction;
""",
    "q103": """
CREATE MATERIALIZED VIEW nexmark_q103 AS
SELECT
    a.id AS auction_id,
    a.item_name AS auction_item_name
FROM auction a
WHERE a.id IN (
    SELECT b.auction FROM bid b
    GROUP BY b.auction
    HAVING COUNT(*) >= 20
);
""",
    "q104": """
CREATE MATERIALIZED VIEW nexmark_q104 AS
SELECT
    a.id AS auction_id,
    a.item_name AS auction_item_name
FROM auction a
WHERE a.id NOT IN (
    SELECT b.auction FROM bid b
    GROUP BY b.auction
    HAVING COUNT(*) < 20
);
""",
    "q102": """
CREATE MATERIALIZED VIEW nexmark_q102 AS
SELECT
    a.id AS auction_id,
    a.item_name AS auction_item_name,
    COUNT(b.auction) AS bid_count
FROM auction a
JOIN bid b ON a.id = b.auction
GROUP BY a.id, a.item_name
HAVING COUNT(b.auction) >= (
    SELECT COUNT(*) / COUNT(DISTINCT auction) FROM bid
);
""",
}
JOIN_QUERIES = ("q101", "q103", "q104")
#: bench.py's PlannerConfig (join tables 2^22 left and 2^18 right, bucket
#: 64, pool 2^22, out capacity 4096), the MV at 2^22: q101 and q104 hold
#: every auction of the run (41 barriers x 8 x 8192 = 2,686,976)
JOIN_CONFIG = dict(BENCH_CONFIG, join_left_table_size=1 << 22,
                   join_right_table_size=1 << 18, join_pool_size=1 << 22,
                   join_out_capacity=1 << 12, mv_table_size=1 << 22)
#: the sources' SQL names in each query's DagJob (auction, bid)
JOIN_SOURCE_NAMES = {"q101": ("a", "b1"), "q103": ("a", "b"),
                     "q104": ("a", "b")}
#: auction columns regenerated for the checks: id, item_name, date_time
JOIN_AUCTION_COLS = (0, 1, 5)


def _join_config(scale: int, over=None) -> dict:
    cfg = {k: max(v // scale, 64) for k, v in JOIN_CONFIG.items()}
    cfg.update(over or {})
    return cfg


def _join_engine(torch, device, scale, query: str, barriers: int,
                 over=None):
    """A ``query`` engine at the slice's sizes (divided by ``scale``)
    after ``barriers`` barriers of 8 rounds (an auction and a bid chunk
    each)."""
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig

    eng = Engine(PlannerConfig(**_join_config(scale, over)), device=device)
    eng.execute(JOIN_SOURCES)
    eng.execute(JOIN_QUERY_SQL[query])
    eng.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1000000")
    eng.execute("ALTER SYSTEM SET snapshot_interval_checkpoints = 8")
    eng.tick(barriers=barriers, chunks_per_barrier=CHUNKS_PER_BARRIER)
    return eng


def _col_planes(tag, col):
    """(name, tensor) of a column's planes: payload, lengths, nulls."""
    from risingwave_tpu_torch.common.chunk import NCol, StrCol

    if isinstance(col, NCol):
        return _col_planes(tag, col.data) + [(f"{tag} null", col.null)]
    if isinstance(col, StrCol):
        return [(f"{tag} bytes", col.data), (f"{tag} lens", col.lens)]
    return [(tag, col)]


def _window_pairs(tag, a, b):
    """Plane pairs of two emission windows (kernel, plain), on the card."""
    dev = a[1].device
    pairs = [(f"{tag} ops", a[1], b[1].to(dev)),
             (f"{tag} valid", a[2], b[2].to(dev)),
             (f"{tag} probe_bound", a[3], b[3].to(dev))]
    for ci, (ca, cb) in enumerate(zip(a[0], b[0])):
        pa, pb = _col_planes(f"{tag} column {ci}", ca), \
            _col_planes(f"{tag} column {ci}", cb)
        if len(pa) != len(pb):
            fail(f"{tag} column {ci}: planes differ")
        pairs += [(n, x, y.to(dev)) for (n, x), (_, y) in zip(pa, pb)]
    return pairs


def _state_equal(tag, card, cpu) -> None:
    from risingwave_tpu_torch.compat import state_mismatches, state_to_numpy

    bad = state_mismatches(state_to_numpy(cpu), card)
    if bad:
        fail(f"{tag}: the card's state differs from the CPU plain "
             f"version: {bad[:5]}")


#: the edge-case schemas: strings on both sides, a nullable right column
EDGE_LEFT = (("k", "INT64", False, 0), ("a", "INT64", False, 0),
             ("s", "VARCHAR", False, 8))
EDGE_RIGHT = (("k", "INT64", False, 0), ("b", "INT64", True, 0),
              ("t", "VARCHAR", False, 8))


def _edge_schema(cols):
    from risingwave_tpu_torch.common.types import DataType, Field, Schema

    return Schema(tuple(Field(n, getattr(DataType, t), nullable=nl,
                              **({"str_width": w} if w else {}))
                        for n, t, nl, w in cols))


def _edge_script(rng, left_dense: bool, right_dense: bool):
    """Chunks of (side, rows, ops) over keys 0..5: duplicates of one
    value, a delete and an insert of one value in one chunk, deletes
    with no stored match and full 4-deep buckets on the dense sides; a
    pool side only appends."""
    live = {"left": [], "right": []}
    script = []
    for step in range(10):
        side = "left" if step % 2 == 0 else "right"
        dense = left_dense if side == "left" else right_dense
        rows, ops = [], []
        for _ in range(int(rng.integers(3, 10))):
            k = int(rng.integers(0, 6))
            v = int(rng.integers(0, 3))
            row = (k, v, f"x{v}") if side == "left" else (
                k, None if v == 2 else v, f"y{k}")
            rows.append(row)
            ops.append(0)
        if dense:
            if live[side]:
                for i in rng.choice(len(live[side]),
                                    min(3, len(live[side])), replace=False):
                    rows.append(live[side][int(i)])
                    ops.append(1)
            rows.append(rows[0])       # the first insert annihilates
            ops.append(1)
            if step % 3 == 1:          # a delete with no stored match
                rows.append((9, 9, "zz") if side == "left"
                            else (9, None, "zz"))
                ops.append(1)
        for r, o in zip(rows, ops):
            if o == 0:
                live[side].append(r)
            elif r in live[side]:
                live[side].remove(r)
        script.append((side, rows, ops))
    return script


def phase_join_edge_cases(torch, device) -> str:
    """Every join type over dense/dense, pool/dense and pool/pool sides
    on the card against the CPU plain versions, chunk by chunk: K13d on
    the dense sides, K12/K13 on the pool sides and every K14 window
    (pads, semi/anti columns, transitions), strings and NULLs included,
    buckets of 4 (full), windows of 8 rows; every window plane and every
    state tensor must be equal."""
    import numpy as np

    from risingwave_tpu_torch.common.chunk import Chunk
    from risingwave_tpu_torch.expr.node import InputRef
    from risingwave_tpu_torch.stream import hash_join as hj

    ls, rs = _edge_schema(EDGE_LEFT), _edge_schema(EDGE_RIGHT)
    cpu = torch.device("cpu")
    n_windows = n_chunks = 0
    over = inc = 0
    for storage in ("dense_dense", "pool_dense", "pool_pool"):
        lst, rst = storage.split("_")
        script = _edge_script(np.random.default_rng(len(storage)),
                              lst == "dense", rst == "dense")
        for jt in hj.JOIN_TYPES:
            ex = hj.HashJoinExecutor(
                ls, rs, [InputRef(0)], [InputRef(0)], table_size=16,
                bucket_cap=4, out_capacity=8, join_type=jt,
                left_storage=lst, right_storage=rst, left_pool_size=256,
                right_pool_size=256)
            sk, sp = ex.init_state(device), ex.init_state(cpu)
            for side, rows, ops in script:
                schema = ls if side == "left" else rs
                arrays = [np.array([r[i] for r in rows], object)
                          for i in range(3)]
                opa = np.asarray(ops, np.int8)
                ck = Chunk.from_numpy(schema, arrays, ops=opa, capacity=16,
                                      device=device)
                cp = Chunk.from_numpy(schema, arrays, ops=opa, capacity=16)
                sk, pk = ex.apply_begin(sk, ck, side)
                sp, pp = ex.apply_begin(sp, cp, side)
                total = int(pp.total)
                if int(pk.total) != total:
                    fail(f"join edge cases {jt} {storage}: emission "
                         f"totals differ")
                bk, bp = ex.build_rows_of(sk, side), ex.build_rows_of(sp,
                                                                      side)
                pairs = []
                for w in range(max(1, -(-total // 8))):
                    ok_, bound_k = ex.emit_window(bk, pk, w, side)
                    op_, bound_p = ex.emit_window(bp, pp, w, side)
                    pairs += _window_pairs(
                        f"{jt} {storage} window {w}",
                        (ok_.columns, ok_.ops, ok_.valid, bound_k),
                        (op_.columns, op_.ops, op_.valid, bound_p))
                    n_windows += 1
                max_abs_err(torch, pairs)
                _state_equal(f"join edge cases {jt} {storage}", sk,
                             sp)
                n_chunks += 1
            for s_ in (sp.left, sp.right):
                over += int(s_.overflow)
                inc += int(s_.inconsistency)
    msg = (f"{n_chunks} chunks, {n_windows} windows over 8 join types x "
           f"(dense/dense, pool/dense, pool/pool): every window plane and "
           f"state tensor equal (overflow {over}, inconsistency {inc} on "
           f"both)")
    if not (over and inc):
        fail(f"join edge cases reached no full bucket or no unmatched "
             f"delete: {msg}")
    print(f"[join_dense] exact on the edge cases: {msg}", flush=True)
    return msg


def _inverse(torch, chunk):
    """The chunk with every op inverted (Insert <-> Delete, U- <-> U+)."""
    from risingwave_tpu_torch.common.chunk import Chunk

    flip = torch.tensor([1, 0, 3, 2], dtype=torch.int8, device=chunk.device)
    return Chunk(chunk.columns, flip[chunk.ops.to(torch.int64)],
                 chunk.valid, chunk.schema)


def phase_join_kernels(torch, device, timer, scale):
    """K13d, K14 over a dense build and over a pool build with
    transitions, the spill capture and a dense side's clean and rebuild,
    at q101's main-path shapes: the state of a q101 engine at the slice's
    sizes after 6 barriers, its next auction chunk, the next bid chunk
    through the aggregation and the aggregation's flush (U-/U+ pairs)
    into the dense side, each kernel against its plain version on CPU
    copies (plain times on the card).  Then the edge cases."""
    from risingwave_tpu_torch.common.chunk import Chunk
    from risingwave_tpu_torch.common.hash import hash64_columns
    from risingwave_tpu_torch.common.tree import tree_map
    from risingwave_tpu_torch.stream import hash_agg as ha
    from risingwave_tpu_torch.stream import hash_join as hj
    from risingwave_tpu_torch.stream.spill import chunk_to

    cpu = torch.device("cpu")

    def clone(t):
        return tree_map(torch.clone, t)

    def to_cpu(t):
        return tree_map(lambda x: x.to(cpu, copy=True), t)

    eng = _join_engine(torch, device, scale, "q101", 6)
    job = eng.jobs[0]
    join = job.nodes[3].join
    src_a, src_b = JOIN_SOURCE_NAMES["q101"]
    # the next barrier: its auction chunks go to the pool, its bid chunks
    # through the aggregation, whose flush is the dense side's input
    states = list(clone(job.states))
    for _ in range(CHUNKS_PER_BARRIER):
        _, achunk = job.nodes[0].fragment.step(
            states[0], job.sources[src_a].next_chunk())
        _, bchunk = job.nodes[1].fragment.step(
            states[1], job.sources[src_b].next_chunk())
        states[2], _ = job.nodes[2].fragment.step(states[2], bchunk)
    _, outs = job.nodes[2].fragment.flush(states[2], job.epoch.curr.value)
    rchunk = outs[0]
    cap = rchunk.capacity
    right = job.states[3].right
    B = right.occupied.shape[1]
    out = {}

    # -- K13d join_dense: the agg's flush into the dense side -------------
    key_cols, null_keys = hj._null_stripped_keys(
        [e.eval(rchunk) for e in join.right_keys])
    h = hash64_columns(key_cols)
    rc_cpu = chunk_to(rchunk, cpu)
    kc_cpu, nk_cpu = hj._null_stripped_keys(
        [e.eval(rc_cpu) for e in join.right_keys])
    sk, sp = clone(right), to_cpu(right)
    hj.update_side_dense(sk, rchunk, key_cols, null_keys, h)
    hj.update_side_dense_plain(sp, rc_cpu, kc_cpu, nk_cpu,
                               hash64_columns(kc_cpu))
    _state_equal("join_dense on q101's flush", sk, sp)
    signs = rchunk.signs()
    n_del = int((rchunk.valid & (signs < 0)).sum())
    n_ins = int((rchunk.valid & (signs > 0)).sum())
    live = int(sp.count.sum())
    keys = int(sp.key_table.occupied.sum())
    # the flush's inverse: its inserts come back as deletes by value
    inv = _inverse(torch, rchunk)
    hj.update_side_dense(sk, inv, key_cols, null_keys, h)
    hj.update_side_dense_plain(sp, _inverse(torch, rc_cpu), kc_cpu, nk_cpu,
                               hash64_columns(kc_cpu))
    _state_equal("join_dense on the flush's inverse", sk, sp)
    inv_inc = int(sp.inconsistency) - int(right.inconsistency)
    del sk, sp
    work = clone(right)
    fwd = hj.dense_update_args_cuda(work, rchunk, key_cols, null_keys, h) \
        if device.type == "cuda" else None
    n_it = 21
    if device.type == "cuda":
        hj.join_dense_cuda(work, rchunk, *fwd)
        back = hj.dense_update_args_cuda(work, inv, key_cols, null_keys, h)
        upd_ms = timer(lambda i: hj.join_dense_cuda(
            work, *((inv, *back) if (i - n_it) % 2 == 0
                    else (rchunk, *fwd))), n_it)
        ins, dels = rchunk.valid & (signs > 0), rchunk.valid & (signs < 0)
        # 100 calls behind 200 ms of pre-fill: each call's host work (a
        # sort and a few allocations) stays hidden behind the sleep
        cancel_ms = timer(lambda i: hj.bucket_cancel_cuda(
            "join_dense", fwd[0], ins, dels), 100, prefill_ms=2.0)
        sort_ms = timer(lambda i: torch.sort(hj._sort_key(
            fwd[0], ins | dels), stable=True), 100, prefill_ms=2.0)
        cancel_ms -= sort_ms
        ms = upd_ms + cancel_ms
    else:
        upd_ms = cancel_ms = sort_ms = 0.0
        ms = timer(lambda i: None, 1)
    whole = clone(right)
    whole_ms = timer(lambda i: hj.update_side_dense(
        whole, rchunk if (i - n_it) % 2 == 0 else inv, key_cols, null_keys,
        h), n_it)
    pwork = clone(right)
    plain_ms = timer(lambda i: hj.update_side_dense_plain(
        pwork, rchunk if (i - 5) % 2 == 0 else inv, key_cols, null_keys, h),
        5)
    side_row = sum(row_bytes(c, 2) for c in right.rows)
    per_key = live / max(keys, 1)

    def dense_bytes(nd, ni):
        # the insert and delete flags of every row; per active row its
        # slot, rank and row hash (16 B), its bucket's B occupancy bytes,
        # one occupancy byte and its key's count written; a delete hashes
        # its key's live rows, an insert writes its row
        return cap * 2 + (nd + ni) * (16 + B + 1 + 4) \
            + nd * per_key * side_row + ni * side_row

    # the timing alternates the flush and its inverse
    nbytes = (dense_bytes(n_del, n_ins) + dense_bytes(n_ins, n_del)) / 2
    b = bound(nbytes, (n_del + n_ins) / 2 * per_key * 2 * 12)
    print(f"[join_dense] exact (q101's flush: {n_del} deletes, {n_ins} "
          f"inserts into {keys} keys x {B}; its inverse: {n_ins} deletes "
          f"by value, {inv_inc} unmatched); kernel {ms:.4f} ms "
          f"(annihilation {cancel_ms:.4f} + update {upd_ms:.4f}; the sort "
          f"before the annihilation {sort_ms:.4f} ms apart), whole "
          f"update with K1/K3/ranks {whole_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b[0]:.5f} ms", flush=True)
    out["join_dense"] = kernel_entry(
        "join_dense.cu", "risingwave_tpu/stream/hash_join.py:492", ms,
        plain_ms, b, None, 0.0)
    out["join_dense"].update(whole_update_ms=whole_ms, sort_ms=sort_ms,
                             annihilation_ms=cancel_ms, update_ms=upd_ms,
                             inverse_unmatched=inv_inc)
    del work, whole, pwork

    # -- K14 over the dense build: the auction chunk probes the bids' max -
    st = clone(job.states[3])
    st, pend = join.apply_begin(st, achunk, "left")
    rows, index = join.build_rows_of(st, "left")
    occ = index[1]
    spec = join._specs["left"]
    out_cap = join.out_capacity
    rows_c, index_c, pend_c = to_cpu(rows), ("dense", occ.cpu()), \
        to_cpu(pend)
    total = int(pend.total)
    pairs = []
    for w in range(-(-total // out_cap)):
        ek = hj.emit_window(rows, index, pend, w, out_cap, spec)
        ep = hj.emit_window_plain(rows_c, index_c, pend_c, w, out_cap, spec)
        pairs += _window_pairs(f"dense build window {w}", ek, ep)
    err = max_abs_err(torch, pairs)
    n_pairs, n_pads = int(pend.P), int(pend.S)
    dms = timer(lambda i: hj.emit_window(rows, index, pend, 0, out_cap,
                                         spec), 200)
    dplain_ms = timer(lambda i: hj.emit_window_plain(
        rows, index, pend, 0, out_cap, spec), 5)
    # a pair reads its bucket's B occupancy bytes
    db = emit_bound(pend, 0, out_cap, ek[0], spec, B)
    print(f"[join_emit] exact over a dense build ({total} outputs of an "
          f"auction chunk: {n_pairs} pairs, {n_pads} NULL-padded rows); "
          f"kernel {dms:.4f} ms a window, plain {dplain_ms:.4f} ms, bound "
          f"{db[0]:.5f} ms", flush=True)
    # the same chunk with the ids of keys that hold bids in its first
    # rows: pairs through the kernel at full width
    ki = join.left_keys[0].index
    kt = job.states[3].right.key_table
    bid_keys = kt.key_cols[0][kt.occupied & (job.states[3].right.count > 0)]
    n_hit = min(bid_keys.numel(), achunk.capacity // 2)
    ids = achunk.columns[ki].clone()
    ids[:n_hit] = bid_keys[:n_hit]
    hit = Chunk(tuple(ids if c == ki else col
                      for c, col in enumerate(achunk.columns)),
                achunk.ops, achunk.valid, achunk.schema)
    st_h = clone(job.states[3])
    st_h, pend_h = join.apply_begin(st_h, hit, "left")
    rows_h, index_h = join.build_rows_of(st_h, "left")
    rows_hc, index_hc, pend_hc = to_cpu(rows_h), \
        ("dense", index_h[1].cpu()), to_cpu(pend_h)
    total_h, n_pairs_h = int(pend_h.total), int(pend_h.P)
    if not n_pairs_h:
        fail("K14 over the dense build: the keyed chunk found no pairs")
    pairs = []
    for w in range(-(-total_h // out_cap)):
        ek_h = hj.emit_window(rows_h, index_h, pend_h, w, out_cap, spec)
        ep_h = hj.emit_window_plain(rows_hc, index_hc, pend_hc, w, out_cap,
                                    spec)
        pairs += _window_pairs(f"dense build pairs window {w}", ek_h, ep_h)
    err = max(err, max_abs_err(torch, pairs))
    hms = timer(lambda i: hj.emit_window(rows_h, index_h, pend_h, 0,
                                         out_cap, spec), 200)
    hplain_ms = timer(lambda i: hj.emit_window_plain(
        rows_h, index_h, pend_h, 0, out_cap, spec), 5)
    hb = emit_bound(pend_h, 0, out_cap, ek[0], spec, B)
    print(f"[join_emit] exact over a dense build with pairs ({total_h} "
          f"outputs: {n_pairs_h} pairs over {B}-deep buckets, "
          f"{int(pend_h.S)} NULL-padded rows); kernel {hms:.4f} ms on "
          f"window 0, plain {hplain_ms:.4f} ms, bound {hb[0]:.5f} ms",
          flush=True)
    del st_h, rows_h, rows_hc, pend_h, pend_hc

    # -- K14 over the pool build: the flush probes the auctions ----------
    st2 = clone(job.states[3])
    st2, pend2 = join.apply_begin(st2, rchunk, "right")
    rows2, index2 = join.build_rows_of(st2, "right")
    spec2 = join._specs["right"]
    rows2_c = to_cpu(rows2)
    index2_c = ("pool", to_cpu(index2[1]), index2[2].cpu())
    pend2_c = to_cpu(pend2)
    total2 = int(pend2.total)
    pairs = []
    for w in range(max(1, -(-total2 // out_cap))):
        ek = hj.emit_window(rows2, index2, pend2, w, out_cap, spec2)
        ep = hj.emit_window_plain(rows2_c, index2_c, pend2_c, w, out_cap,
                                  spec2)
        pairs += _window_pairs(f"pool build window {w}", ek, ep)
    err = max(err, max_abs_err(torch, pairs))
    n_up, n_down = int(pend2.U), int(pend2.down_end[-1])
    pms = timer(lambda i: hj.emit_window(rows2, index2, pend2, 0, out_cap,
                                         spec2), 200)
    pplain_ms = timer(lambda i: hj.emit_window_plain(
        rows2, index2, pend2, 0, out_cap, spec2), 5)
    # a pair or transition reads its build row's tag and pool_pos
    pb = emit_bound(pend2, 0, out_cap, ek[0], spec2, 12)
    print(f"[join_emit] exact over a pool build with transitions ({total2} "
          f"outputs of the flush: {n_up} pads retracted, {int(pend2.P)} "
          f"pairs, {n_down} returned); kernel {pms:.4f} ms a window, plain "
          f"{pplain_ms:.4f} ms, bound {pb[0]:.5f} ms", flush=True)
    emit_extra = dict(dense_ms=dms, dense_plain_ms=dplain_ms,
                      dense_bound_ms=db[0], dense_bound_by=db[1],
                      dense_shape=f"q101 auction chunk over 2^18 x {B} "
                                  f"buckets: {n_pairs} pairs, {n_pads} pads",
                      dense_pairs_ms=hms, dense_pairs_plain_ms=hplain_ms,
                      dense_pairs_bound_ms=hb[0], dense_pairs_bound_by=hb[1],
                      dense_pairs_shape=f"the same chunk keyed to bids: "
                                        f"{n_pairs_h} pairs",
                      pads_ms=pms, pads_plain_ms=pplain_ms,
                      pads_bound_ms=pb[0], pads_bound_by=pb[1],
                      pads_shape=f"q101 flush over the auction pool: "
                                 f"{n_up} up, {int(pend2.P)} pairs",
                      matrix_max_abs_err=err)
    del st, st2, rows, rows2, rows_c, rows2_c, pend, pend2, pend_c, pend2_c

    # -- the spill capture ------------------------------------------------
    ex = job.nodes[2].fragment.executors[0]
    main_ring = ex.spill_ring
    captured = {}
    orig = ha.spill_capture

    def record(state, chunk, valid, overflow, pa, r):
        captured["args"] = (chunk, valid, overflow, pa)
        return orig(state, chunk, valid, overflow, pa, r)

    ha.spill_capture = record
    try:
        ex.apply(clone(job.states[2][0]), bchunk)
    finally:
        ha.spill_capture = orig
    clean_args = captured["args"]
    # the main path's shape: no row overflows the 2^18 table
    clean_st = clone(job.states[2][0])
    capture = ha.spill_capture_cuda if device.type == "cuda" \
        else ha.spill_capture_plain
    ms_clean = timer(lambda i: capture(clean_st, *clean_args, main_ring),
                     200)
    plain_clean = timer(lambda i: ha.spill_capture_plain(
        clean_st, *clean_args, main_ring), 20)
    if int(clean_st.spill_count) or int(clean_st.overflow):
        fail("spill capture wrote rows on a chunk with no overflow")
    # forced: a 4-slot table of the same aggregation, both branches, with
    # a ring of half the rows that overflow it: the ring fills and the
    # rows past it are lost
    bids = [bchunk]
    for _ in range(7):
        _, c = job.nodes[1].fragment.step(clone(job.states[1]),
                                          job.sources[src_b].next_chunk())
        bids.append(c)
    table = 4
    probe = ha.HashAggExecutor(table_size=table, **ex._ctor_kwargs)
    pst = probe.init_state(cpu)
    for c in bids:
        pst, _ = probe.apply(pst, chunk_to(c, cpu))
    ring = int(pst.overflow) // 2
    if ring < 1:
        fail("spill capture: the bids overflow no 4-slot table")
    small = ha.HashAggExecutor(table_size=table, spill_ring=ring,
                               **ex._ctor_kwargs)
    card_branch = ha.accel_tuned
    n_spilled = 0
    try:
        for preagg in (True, False):
            ha.accel_tuned = lambda d, p=preagg: p
            stk, stp = small.init_state(device), small.init_state(cpu)
            for c in bids:
                stk, _ = small.apply(stk, c)
                stp, _ = small.apply(stp, chunk_to(c, cpu))
                _state_equal(f"spill capture (pre-aggregation "
                             f"{preagg})", stk, stp)
            if int(stp.spill_count) != ring or not int(stp.overflow):
                fail(f"spill capture: the ring holds {int(stp.spill_count)}"
                     f" of {ring} rows, {int(stp.overflow)} lost")
            n_lost = int(stp.overflow)
    finally:
        ha.accel_tuned = card_branch
    # time the chunk that diverts the most rows (the card's branch)
    st0 = small.init_state(device)
    calls = []
    ha.spill_capture = lambda st, *a: (calls.append(a[:-1]), orig(st, *a))
    try:
        stw = clone(st0)
        for c in bids:
            stw, _ = small.apply(stw, c)
    finally:
        ha.spill_capture = orig
    full_args = max(calls, key=lambda a: int(ha.spill_mask_plain(*a[1:])
                                             .sum()))
    full_st = clone(st0)
    ms_full = timer(lambda i: (full_st.spill_count.zero_(),
                               capture(full_st, *full_args, ring)), 50)
    plain_full = timer(lambda i: (full_st.spill_count.zero_(),
                                  ha.spill_capture_plain(full_st, *full_args,
                                                         ring)), 10)
    n_spilled = int(full_st.spill_count)
    bid_bytes = sum(row_bytes(c) for c in bchunk.columns) + 1
    # a clean chunk reads valid, overflow and rep (1 B each a row) to see
    # that nothing diverts; diverting also reads the segment starts, and
    # a spilled row its perm entry (8 B) and its columns and op, once
    # read and once written
    cb = bound(cap * 3, cap * 3)
    fb = bound(cap * 4 + n_spilled * (8 + 2 * bid_bytes), cap * 20)
    print(f"[agg_spill] exact on both branches ({len(bids)} chunks into a "
          f"{table}-slot table: the {ring}-row ring filled, {n_lost} rows "
          f"lost and counted); kernel {ms_clean:.4f} ms on the main path's "
          f"chunk (a {main_ring}-row ring, nothing to divert), plain "
          f"{plain_clean:.4f} ms, bound "
          f"{cb[0]:.5f} ms; {ms_full:.4f} ms diverting {n_spilled} rows, "
          f"plain {plain_full:.4f} ms, bound {fb[0]:.5f} ms", flush=True)
    out["agg_spill"] = kernel_entry(
        "agg_spill.cu", "risingwave_tpu/stream/hash_agg.py:427", ms_clean,
        plain_clean, cb, None, 0.0)
    out["agg_spill"].update(forced_ms=ms_full, forced_plain_ms=plain_full,
                            forced_bound_ms=fb[0], forced_rows=n_spilled)
    del small, stk, stp, full_st, clean_st

    # -- a dense side's clean and rebuild (executor level) ---------------
    ck, cp = clone(right), to_cpu(right)
    kv = right.key_table.key_cols[0][right.key_table.occupied]
    thr = int(kv.median()) if kv.numel() else 0
    t_k = torch.tensor(thr, dtype=torch.int64, device=device)
    sk_ = hj.clean_dense(ck, 0, t_k)
    sp_ = hj.clean_dense(cp, 0, t_k.cpu())
    _state_equal("dense clean_below", ck, cp)
    if not torch.equal(sk_.cpu(), sp_):
        fail("dense clean_below: the tables' counts differ")
    rk, rp = hj.rebuild_dense(ck), hj.rebuild_dense(cp)
    _state_equal("dense rebuild", rk, rp)
    clean_ms = timer(lambda i: hj.clean_dense(clone(right), 0, t_k), 5)
    rebuild_ms = timer(lambda i: hj.rebuild_dense(ck), 5)
    print(f"[join_dense] clean_below and rebuild exact on q101's dense side "
          f"({int(sp_[0])} keys tombstoned of {keys}, rebuilt through K3 and "
          f"K4); clean {clean_ms:.4f} ms (with its clone), rebuild "
          f"{rebuild_ms:.4f} ms", flush=True)
    out["join_dense"].update(clean_ms=clean_ms, rebuild_ms=rebuild_ms)
    del eng, job, states, ck, cp, rk, rp, right
    if device.type == "cuda":
        torch.cuda.empty_cache()
    edge = phase_join_edge_cases(torch, device)
    out["join_dense"]["edge_cases"] = edge
    return out, emit_extra


def _tier_groups(tier):
    """A tier's groups as a sorted list of (keys, row count, prims):
    its contents, whatever the slot layout."""
    import numpy as np

    st = tier.state
    occ = st.table.occupied.cpu().numpy()
    cols = [x.cpu().numpy()[occ] for c in st.table.key_cols
            for x in _leaves_of(c)]
    cols += [st.row_count.cpu().numpy()[occ]]
    cols += [p.cpu().numpy()[occ] for p in st.prims]
    return sorted(zip(*[c.tolist() for c in cols])) if cols else []


def phase_join_parity(torch, device, query: str) -> None:
    """``query`` at 10,000 events/s through the engine on ``device`` and
    on the CPU (plain versions, the agg forced onto the card's
    pre-aggregation branch), chunk 256, the agg table at 16 slots so that
    its spill ring and host tier run, a snapshot every 2 checkpoints: MV
    rows and every state tensor equal, the tiers' groups equal, then the
    same after ``recover()`` and 2 more barriers."""
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig
    from risingwave_tpu_torch.stream import hash_agg

    cfg = PlannerConfig(chunk_capacity=256, agg_table_size=16,
                        agg_emit_capacity=128, agg_spill_table_size=1 << 11,
                        join_table_size=1 << 11, join_bucket_cap=8,
                        join_pool_size=1 << 14, join_out_capacity=256,
                        mv_table_size=1 << 14, distinct_table_size=1 << 11)
    name = f"nexmark_{query}"
    engines = []
    card_branch = hash_agg.accel_tuned

    def run(fn):
        for eng in engines:
            if eng.device.type == "cpu":
                hash_agg.accel_tuned = lambda d: True
            try:
                fn(eng)
            finally:
                hash_agg.accel_tuned = card_branch

    def per_row(apply):
        """The host tier's apply on the per-row branch, as on the card's
        engine (its tier's rows lie on the CPU)."""
        def run_tier(state, chunk):
            forced = hash_agg.accel_tuned
            hash_agg.accel_tuned = card_branch
            try:
                return apply(state, chunk)
            finally:
                hash_agg.accel_tuned = forced
        return run_tier

    for dev in (device, torch.device("cpu")):
        eng = Engine(cfg, device=dev)
        eng.execute(JOIN_SOURCES.replace("'1000000'", "'10000'"))
        eng.execute(JOIN_QUERY_SQL[query])
        eng.execute("ALTER SYSTEM SET snapshot_interval_checkpoints = 2")
        for _, tier in eng.jobs[0]._spill_tiers.values():
            tier.agg.apply = per_row(tier.agg.apply)
        engines.append(eng)

    def compare(stage):
        rows = [sorted(e.execute(f"SELECT * FROM {name}"), key=repr)
                for e in engines]
        if rows[0] != rows[1] or not rows[0]:
            fail(f"{query} MV on the card differs from the CPU ({stage})")
        _state_equal(f"{query} {stage}", engines[0].jobs[0].states,
                     engines[1].jobs[0].states)
        tiers = [[_tier_groups(t) for _, t in e.jobs[0]._spill_tiers.values()]
                 for e in engines]
        if tiers[0] != tiers[1]:
            fail(f"{query} spill tiers differ ({stage})")
        return len(rows[0]), sum(len(t) for t in tiers[0])

    run(lambda e: e.tick(barriers=6, chunks_per_barrier=2))
    n_rows, n_tier = compare("6 barriers")
    run(lambda e: e.recover())
    compare("recover")
    run(lambda e: e.tick(barriers=2, chunks_per_barrier=2))
    compare("recover + 2 barriers")
    if not n_tier:
        fail(f"{query} parity: no group reached the spill tier")
    print(f"[parity] {query} at 10,000 events/s, 6 barriers, recover, 2 "
          f"more: {n_rows} MV rows, all state and the spill tier's "
          f"{n_tier} groups equal to the CPU plain versions", flush=True)


def _consumed_wm(chunk_cols, n: int):
    """numpy columns of the first ``n`` chunks a source produced
    (``chunk_cols(i)`` regenerates chunk ``i``'s columns, the event time
    last), with the watermark filter's late rows dropped."""
    import numpy as np

    parts = None
    keep = []
    max_ts = None
    for i in range(n):
        cols = chunk_cols(i)
        ts = cols[-1].cpu().numpy()
        wm = None if max_ts is None else max_ts - WM_DELAY_US
        keep.append(np.ones(ts.shape[0], bool) if wm is None else ts >= wm)
        max_ts = int(ts.max()) if max_ts is None else max(max_ts,
                                                          int(ts.max()))
        parts = parts or [[] for _ in cols]
        for j, col in enumerate(cols):
            parts[j].append((col.data.cpu().numpy(), col.lens.cpu().numpy())
                            if hasattr(col, "lens") else col.cpu().numpy())
    k = np.concatenate(keep)
    out = []
    for p in parts:
        if isinstance(p[0], tuple):
            out.append((np.concatenate([x[0] for x in p])[k],
                        np.concatenate([x[1] for x in p])[k]))
        else:
            out.append(np.concatenate(p)[k])
    return out


def check_join(eng, query: str, cap: int) -> str:
    """The MV equals numpy over the consumed events: q101 every auction
    with its bids' max (NULL without bids), q103 the auctions with at
    least 20 bids, q104 those with none or at least 20."""
    import numpy as np

    job = eng.jobs[0]
    src_a, src_b = JOIN_SOURCE_NAMES[query]
    ra, rb = job.sources[src_a], job.sources[src_b]
    aid, (aname, alens), _ = _consumed_wm(
        lambda i: ra.inner.gen.gen_auctions(i * cap, cap,
                                            JOIN_AUCTION_COLS).columns,
        ra.offset // cap)
    bauc, bprice, _ = _consumed_wm(
        lambda i: [rb.gen.gen_bids(i * cap, cap).columns[j]
                   for j in (0, 2, 5)], rb.offset // cap)
    if np.unique(aid).shape[0] != aid.shape[0]:
        fail(f"{query} check: an auction id appears twice")
    order = np.argsort(bauc, kind="stable")
    sa, sp = bauc[order], bprice[order]
    first = np.searchsorted(sa, aid, "left")
    last = np.searchsorted(sa, aid, "right")
    counts = last - first
    maxes = np.full(aid.shape[0], -1, np.int64)
    has = counts > 0
    if sa.size:
        seg = np.maximum.reduceat(sp, np.r_[0, np.flatnonzero(
            sa[1:] != sa[:-1]) + 1])
        uniq = sa[np.r_[0, np.flatnonzero(sa[1:] != sa[:-1]) + 1]]
        maxes[has] = seg[np.searchsorted(uniq, aid[has])]
    keep = {"q101": np.ones(aid.shape[0], bool), "q103": counts >= 20,
            "q104": (counts == 0) | (counts >= 20)}[query]
    want_id = aid[keep]
    want_name = _name_key(aname[keep], alens[keep])
    entry = eng.catalog.get(f"nexmark_{query}")
    mv = job.states[entry.mv_state_index[0]][entry.mv_state_index[1]]
    occ = mv.table.occupied
    got_id = mv.values[0][occ].cpu().numpy()
    got_name = _name_key(mv.values[1].data[occ].cpu().numpy(),
                         mv.values[1].lens[occ].cpu().numpy())
    o, w = np.argsort(got_id), np.argsort(want_id)
    if got_id.shape != want_id.shape or not (
            np.array_equal(got_id[o], want_id[w])
            and np.array_equal(got_name[o], want_name[w])):
        fail(f"{query} MV ({got_id.shape[0]} rows) differs from numpy "
             f"({want_id.shape[0]} auctions)")
    msg = (f"MV equals numpy over {aid.shape[0]} auctions and "
           f"{bauc.shape[0]} bids: {want_id.shape[0]} rows")
    if query == "q101":
        mx = mv.values[2]
        got_max = np.where(mx.null[occ].cpu().numpy(), -1,
                           mx.data[occ].cpu().numpy())
        if not np.array_equal(got_max[o], maxes[w]):
            fail("q101 MV's highest bids differ from numpy")
        msg += f", {int(has.sum())} with a highest bid, the rest NULL"
    return msg


def phase_join_main_path(torch, device, scale, query: str):
    """``query`` at the slice's sizes: 9 warm-up barriers, then 32 timed
    barriers of 8 rounds (an auction and a bid chunk each) with the
    launch counters and the host reads taken over the timed window; the
    loss counters audited (0), the spill ring empty, the MV checked with
    numpy."""
    from risingwave_tpu_torch import kernels

    barriers = BARRIERS if device.type == "cuda" else 2
    eng = _join_engine(torch, device, scale, query,
                       WARMUP_BARRIERS if device.type == "cuda" else 1)
    job = eng.jobs[0]
    if device.type == "cuda":
        torch.cuda.synchronize()
    kernels.reset_launches()
    reads0 = (job.window_reads, job.barrier_reads, job.spill_reads)
    t0 = time.perf_counter()
    eng.tick(barriers=barriers, chunks_per_barrier=CHUNKS_PER_BARRIER)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    cap = job.sources[JOIN_SOURCE_NAMES[query][0]].cap
    chunks = barriers * CHUNKS_PER_BARRIER * 2
    rows = chunks * cap
    reads = (job.window_reads - reads0[0], job.barrier_reads - reads0[1],
             job.spill_reads - reads0[2])
    rate = rows / dt
    print(f"[main] {query} {rows} rows (auctions and bids) in {dt:.3f} s = "
          f"{rate:.0f} rows/s; host reads: {reads[0]} emission totals, "
          f"{reads[2]} spill counts = {sum(reads) / chunks:.3f} per chunk; "
          f"port kernel launches {sum(launches.values()) / chunks:.2f} per "
          f"chunk {launches}", flush=True)
    if device.type == "cuda":
        per_chunk = profile_window(torch, eng, query, barriers=1,
                                   chunks_per_barrier=2 * CHUNKS_PER_BARRIER)
        print(f"[main] {query} launches per chunk "
              f"{'not measured' if per_chunk is None else f'{per_chunk:.1f}'}"
              f" (all CUDA kernels, profiled window)", flush=True)
    eng.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1")
    try:
        eng.tick(barriers=1, chunks_per_barrier=0)
    except RuntimeError as e:
        fail(f"{query}: the counter audit raised: {e}")
    st = job.states
    js = st[3]
    agg = st[2][0]
    counters = {"left overflow": js.left.overflow,
                "right overflow": js.right.overflow,
                "left inconsistency": js.left.inconsistency,
                "right inconsistency": js.right.inconsistency,
                "emit_overflow": js.emit_overflow,
                "agg overflow": agg.overflow,
                "spill ring": agg.spill_count,
                "late auctions": st[0][0].late_rows,
                "late bids": st[1][0].late_rows}
    vals = {k: int(v) for k, v in counters.items()}
    tier = next(iter(job._spill_tiers.values()))[1]
    if any(vals.values()) or tier.rows_absorbed:
        fail(f"{query}: loss counters {vals}, tier rows "
             f"{tier.rows_absorbed}")
    print(f"[check] {query} overflow, inconsistency and emit_overflow 0, "
          f"spill ring empty, no late rows; dense side "
          f"{int(js.right.count.sum())} rows in "
          f"{int(js.right.key_table.occupied.sum())} keys, auction "
          f"pool {int(js.left.pool_len)} rows", flush=True)
    print(f"[check] {query} {check_join(eng, query, cap)}", flush=True)
    del eng, job, st, js, agg
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return launches, rate


# ---------------------------------------------------------------------------
# q102: an aggregation over a join filtered by a moving scalar (K21, the
# dynamic filter), COUNT(DISTINCT) in the scalar (K6d and the K4 sweep) and
# a VARCHAR group key (K5 with strings)


def _q102_over(scale: int) -> dict:
    """q102's sizes over JOIN_CONFIG: the filter's pool and the MV at
    2^18 (the pool holds one row per auction with bids: 26,990 in the
    join slice's runs; the default max(4096, 2 x 8192) would overflow)."""
    return {k: max(v // scale, 64) for k, v in
            dict(topn_pool_size=1 << 18, mv_table_size=1 << 18).items()}


def _rhs_chunk(torch, schema, cap, values, ops):
    """A chunk of the scalar's changelog (the global aggregation's
    projection: the value, then the hidden group key)."""
    import numpy as np

    from risingwave_tpu_torch.common.chunk import Chunk

    vals = np.array(values, np.int64)
    return Chunk.from_numpy(schema, [vals, np.zeros(len(vals), np.int32)],
                            ops=np.array(ops, np.int8), capacity=cap)


def phase_q102_kernels(torch, device, timer, scale):
    """K6d, the K4 sweep, K21 and K5 with string keys at q102's main-path
    shapes, on the state of a q102 engine at the slice's sizes after 6
    barriers, each against its plain version on CPU copies (plain times
    on the card): K6d on the next bid chunk into the global aggregation's
    2^18-slot dedup table and on its inverse (deletes that retract keys
    to 0); the K4 sweep by slot list (the dead keys) and by predicate
    over that table and over the join's 2^22-entry tag table; K5 on a
    join output window keyed (int64, VARCHAR), and with hashes forced
    equal in runs of 4; K16 and K21's left pass on the aggregation's
    U-/U+ flush into the filter's 2^18-row pool; K21's right pass with
    the threshold up, down, emptied and set again."""
    import numpy as np

    from risingwave_tpu_torch.common.tree import tree_map
    from risingwave_tpu_torch.stream import dynamic_filter as df
    from risingwave_tpu_torch.stream import hash_agg as ha
    from risingwave_tpu_torch.stream import top_n
    from risingwave_tpu_torch.stream.spill import chunk_to

    cpu = torch.device("cpu")
    cuda = device.type == "cuda"

    def clone(t):
        return tree_map(torch.clone, t)

    def to_cpu(t):
        return tree_map(lambda x: x.to(cpu, copy=True), t)

    eng = _join_engine(torch, device, scale, "q102", 6, over=_q102_over(scale))
    job = eng.jobs[0]
    states = list(clone(job.states))
    out = {}
    card_branch = ha.accel_tuned

    def on_cpu(fn):
        """Run ``fn`` with the CPU forced onto the card's branch."""
        ha.accel_tuned = lambda d: True
        try:
            return fn()
        finally:
            ha.accel_tuned = card_branch

    # -- K6d: the next bid chunk into the global aggregation's dedup -------
    bchunk = None
    for _ in range(2):
        _, bchunk = job.nodes[4].fragment.step(
            states[4], job.sources["bid"].next_chunk())
    gex = job.nodes[5].fragment.executors[0]
    gk, gp = clone(job.states[5][0]), to_cpu(job.states[5][0])
    calls = []
    orig = ha.distinct_dedup
    ha.distinct_dedup = lambda *a: (calls.append([x.clone() for x in a]),
                                    orig(*a))[1]
    try:
        cap = bchunk.capacity
        steps = (("inserts", bchunk), ("the inverse", _inverse(torch,
                                                               bchunk)))
        tomb0 = int(gp.distinct_tables[0].tombstone_count())
        for tag, c in steps:
            gk, _ = gex.apply(gk, c)
            gp, _ = on_cpu(lambda: gex.apply(gp, chunk_to(c, cpu)))
            _state_equal(f"agg_distinct on {tag}", gk, gp)
    finally:
        ha.distinct_dedup = orig
    n_dead = int(gp.distinct_tables[0].tombstone_count()) - tomb0
    if n_dead <= 0:
        fail("agg_distinct: the inverse chunk retracted no key to 0")
    # rehash_d (K3 over the dedup table, K4 with its counts) at the next
    # maintenance: the table forced past a quarter tombstones by marking
    # free slots, spread over the table, on both copies
    dt_k = gk.distinct_tables[0]
    n_tomb = gex.distinct_table_size // 4 + 1
    free = (~dt_k.occupied & ~dt_k.tombstone).nonzero().flatten()
    need = n_tomb - int(dt_k.tombstone_count())
    mark = free[::max(free.numel() // need, 1)][:need]
    dt_k.tombstone[mark] = True
    gp.distinct_tables[0].tombstone[mark.cpu()] = True
    gk, gp = gex.maybe_rehash(gk), gex.maybe_rehash(gp)
    _state_equal("agg_distinct rehash_d", gk, gp)
    if int(gk.distinct_tables[0].tombstone_count()):
        fail("agg_distinct: rehash_d left tombstones in the dedup table")
    # the card's calls (the CPU's apply records the odd ones)
    ins_args, inv_args = calls[0], calls[2]
    pairs = []
    for tag, a in (("inserts", ins_args), ("inverse", inv_args)):
        ak = [x.clone() for x in a]
        ap = [x.to(cpu, copy=True) for x in a]
        rk = ha.distinct_dedup(*ak)
        rp = ha.distinct_dedup_plain(*ap)
        pairs += [(f"agg_distinct {tag} sign", rk[0], rp[0]),
                  (f"agg_distinct {tag} dead", rk[1], rp[1]),
                  (f"agg_distinct {tag} counts", ak[0], ap[0]),
                  (f"agg_distinct {tag} overflow", ak[7], ap[7]),
                  (f"agg_distinct {tag} inconsistency", ak[8], ap[8])]
    err = max_abs_err(torch, [(n, x, y.to(device)) for n, x, y in pairs])
    size_d = ins_args[0].shape[0]
    live_d = int(gk.distinct_tables[0].occupied.sum())
    n_keys = int(torch.unique(ins_args[1][ins_args[3] & ~ins_args[4]])
                 .numel())
    work = [x.clone() for x in ins_args]
    kernel = ha.distinct_dedup_cuda if cuda else ha.distinct_dedup_plain
    ms = timer(lambda i: kernel(*work), 200)
    plain_ms = timer(lambda i: ha.distinct_dedup_plain(*work), 20)
    # per row: slot 4, three flags 3, rank 4, sign 4 read; sign 8 and the
    # dead flag 1 written; each key's count read and written once
    b = bound(cap * 24 + n_keys * 16, cap * 12)
    print(f"[agg_distinct] exact (the next {cap}-bid chunk into the 2^"
          f"{size_d.bit_length() - 1} dedup table: {n_keys} keys of "
          f"{live_d} live; its inverse: {n_dead} keys retracted to 0 and "
          f"tombstoned; rehash_d past {n_tomb} tombstones: exact); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {b[0]:.6f} ms", flush=True)
    out["agg_distinct"] = kernel_entry(
        "agg_distinct.cu", "risingwave_tpu/stream/hash_agg.py:501", ms,
        plain_ms, b, None, err)
    out["agg_distinct"].update(keys=n_keys, dead_keys=n_dead,
                               rehash_tombstones=n_tomb)

    # -- the K4 sweep -------------------------------------------------------
    dtab = job.states[5][0].distinct_tables[0]
    dslots, dead_rows = inv_args[1], ha.distinct_dedup_plain(
        *[x.to(cpu, copy=True) for x in inv_args])[1].to(device)
    n_rows_dead = int(dead_rows.sum())
    tk, tp = dtab.clone(), to_cpu(dtab)
    tk.clear_slots(dslots, dead_rows)
    tp.clear_slots(dslots.cpu(), dead_rows.cpu())
    _state_equal("table_sweep slot list (dedup table)", tk, tp)
    keys0 = dtab.key_cols[1]
    thr = keys0[dtab.occupied].median() if int(dtab.occupied.sum()) else 0
    pred = dtab.occupied & (keys0 < thr)
    tk, tp = dtab.clone(), to_cpu(dtab)
    tk.clear_where(pred)
    tp.clear_where(pred.cpu())
    _state_equal("table_sweep predicate (dedup table)", tk, tp)
    n_pred = int((pred & dtab.occupied).sum())
    tags = job.states[2].left.table
    g = torch.Generator(device="cpu").manual_seed(21)
    tpred = (torch.rand(tags.size, generator=g) < 0.1).to(device)
    tslots = torch.randint(0, tags.size + 1, (cap,), generator=g,
                           dtype=torch.int32).to(device)
    tmask = (torch.rand(cap, generator=g) < 0.5).to(device)
    for tag, fn in (("predicate", lambda t, d: t.clear_where(
            tpred.to(d))), ("slot list", lambda t, d: t.clear_slots(
                tslots.to(d), tmask.to(d)))):
        kk, pp = tags.clone(), to_cpu(tags)
        fn(kk, device)
        fn(pp, cpu)
        _state_equal(f"table_sweep {tag} (tag table)", kk, pp)
    sw = dtab.clone()
    ms = timer(lambda i: sw.clear_slots(dslots, dead_rows), 200)
    plain_ms = timer(lambda i: sw.clear_slots_plain(dslots, dead_rows), 20)
    # only the elements the work needs: the mask (a row) or pred (a slot)
    # read; the masked rows' slots, the predicated slots' occupancy or tag
    # read; the cleared slots' planes written
    b = bound(cap + n_rows_dead * (4 + 2), cap + n_rows_dead * 2)
    pms = timer(lambda i: sw.clear_where(pred), 200)
    pplain = timer(lambda i: sw.clear_where_plain(pred), 20)
    pb = bound(size_d + n_pred * 3, size_d + n_pred * 2)
    n_tpred = int(tpred.sum())
    n_thit = int((tpred & tags.occupied).sum())
    tt = tags.clone()
    tms = timer(lambda i: tt.clear_where(tpred), 50)
    tb = bound(tags.size + n_tpred * 8 + n_thit * 8,
               tags.size + n_tpred * 3)
    print(f"[table_sweep] exact (the dedup table's {n_rows_dead} dead keys "
          f"by slot list, {n_pred} slots by predicate over 2^"
          f"{size_d.bit_length() - 1}; the join's 2^"
          f"{tags.size.bit_length() - 1}-entry tag table both ways); "
          f"kernel {ms:.4f} ms by slot list, plain {plain_ms:.4f} ms, bound "
          f"{b[0]:.6f} ms; by predicate {pms:.4f} ms, plain {pplain:.4f} "
          f"ms, bound {pb[0]:.6f} ms; tag table by predicate {tms:.4f} ms, "
          f"bound {tb[0]:.5f} ms", flush=True)
    out["table_sweep"] = kernel_entry(
        "table_sweep.cu", "risingwave_tpu/state/hash_table.py:344", ms,
        plain_ms, b, None, 0.0)
    out["table_sweep"].update(
        predicate_ms=pms, predicate_plain_ms=pplain, predicate_bound_ms=pb[0],
        predicate_bound_by=pb[1], tags_predicate_ms=tms,
        tags_predicate_bound_ms=tb[0], tags_predicate_bound_by=tb[1])
    del tk, tp, sw, tt

    # -- K5 with string keys: a join output window into the aggregation ---
    join = job.nodes[2].join
    jst = clone(job.states[2])
    for _ in range(4):
        _, c = job.nodes[1].fragment.step(states[1],
                                          job.sources["b"].next_chunk())
        jst, pend = join.apply_begin(jst, c, "right")
        if int(pend.total):
            break
    win, _ = join.emit_window(join.build_rows_of(jst, "right"), pend, 0,
                              "right")
    aex = job.nodes[3].fragment.executors[0]
    got = []
    orig_pa = ha.agg_preagg
    ha.agg_preagg = lambda *a: (got.append(a), orig_pa(*a))[1]
    try:
        on_cpu(lambda: aex.apply(clone(job.states[3][0]), win))
    finally:
        ha.agg_preagg = orig_pa
    key_cols, h, valid, signs, modes, inits, values = got[0]
    if not any(hasattr(c, "lens") for c in key_cols):
        fail("agg_preagg: the aggregation's keys hold no string")
    pk = ha.agg_preagg_cuda if cuda else ha.agg_preagg_plain
    n = h.shape[0]
    forced = h[torch.arange(n, device=device) & ~3]
    pairs = []
    runs = {}
    for tag, hh in (("q102", h), ("equal hashes", forced)):
        sk, perm = ha.sort_by_hash(hh, valid)
        a = pk(sk, perm, key_cols, valid, signs, modes, inits, values)
        c_sk, c_perm, c_keys, c_valid, c_signs = to_cpu(
            (sk, perm, tuple(key_cols), valid, signs))
        bp = ha.agg_preagg_plain(c_sk, c_perm, list(c_keys), c_valid,
                                 c_signs, modes, inits,
                                 list(to_cpu(tuple(values))))
        for name in ("s_hash", "starts", "rep", "seg_rows", "seg_signs"):
            pairs.append((f"agg_preagg {tag} {name}", getattr(a, name),
                          getattr(bp, name).to(device)))
        pairs += [(f"agg_preagg {tag} key {i} {j}", x, y.to(device))
                  for i, (ca, cb) in enumerate(zip(a.s_keys, bp.s_keys))
                  for j, (x, y) in enumerate(zip(_leaves_of(ca),
                                                 _leaves_of(cb)))]
        pairs += [(f"agg_preagg {tag} prim {i}", x, y.to(device))
                  for i, (x, y) in enumerate(zip(a.seg_values,
                                                 bp.seg_values))]
        runs[tag] = (int(bp.rep.sum()), int(torch.unique(
            hh[valid]).numel()), sk, perm)
    err = max_abs_err(torch, pairs)
    n_rep, n_hash = runs["equal hashes"][:2]
    if n_rep <= n_hash:
        fail("agg_preagg: forced equal hashes split no run by its keys")
    sk, perm = runs["q102"][2:]
    args = (sk, perm, key_cols, valid, signs, modes, inits, values)
    sms = timer(lambda i: pk(*args), 200)
    splain = timer(lambda i: ha.agg_preagg_plain(*args), 20)
    key_b = sum(row_bytes(c) for c in key_cols)
    # per row read: sorted key 8, perm 8, the keys, valid 1, sign 4, a
    # prim 8 each; written: the sorted keys, hash 8, rep 1, starts 1,
    # rows 8, signs 8, a prim 8 each
    sb = bound(n * (2 * key_b + 47 + 16 * len(values)), n * 40)
    print(f"[agg_preagg] exact with string keys ({n} join output rows "
          f"keyed (int64, VARCHAR): {runs['q102'][0]} runs; hashes forced "
          f"equal in runs of 4: {n_rep} runs split by bytes from {n_hash} "
          f"hashes); kernel {sms:.4f} ms, plain {splain:.4f} ms, bound "
          f"{sb[0]:.5f} ms", flush=True)
    preagg_extra = dict(strings_ms=sms, strings_plain_ms=splain,
                        strings_bound_ms=sb[0], strings_bound_by=sb[1],
                        strings_rows=n, strings_max_abs_err=err)

    # -- K16 and K21's left pass: the aggregation's flush into the pool ----
    # two flushes of the join's output for the next bid chunks: the first
    # goes into the pool, the second updates groups it emitted (U-/U+)
    ast_ = clone(job.states[3])
    dex = job.nodes[6].join
    base = clone(job.states[6])
    for rnd in range(2):
        for _ in range(2):
            _, c = job.nodes[1].fragment.step(
                states[1], job.sources["b"].next_chunk())
            jst, pend = join.apply_begin(jst, c, "right")
            rows = join.build_rows_of(jst, "right")
            for w in range(max(1, -(-int(pend.total) // join.out_capacity))):
                win, _ = join.emit_window(rows, pend, w, "right")
                ast_, _ = job.nodes[3].fragment.step(ast_, win)
        _, outs = job.nodes[3].fragment.flush(ast_, job.epoch.curr.value)
        if rnd == 0:
            for o in outs:
                base, _ = dex.apply(base, o, "left")
    left = outs[0]
    S = dex.pool_size
    n_del = int((left.valid & (left.signs() < 0)).sum())
    n_ins = int((left.valid & (left.signs() > 0)).sum())
    if not n_del:
        fail("dyn_filter: the aggregation's flush holds no delete")
    pool_k = top_n.pool_apply_cuda if cuda else \
        (lambda *a: top_n.pool_apply(*a))
    clones = [clone(base) for _ in range(6)]
    ms16 = timer(lambda i: pool_k(clones[i].rows, clones[i].valid,
                                  clones[i].row_hash, left, S,
                                  clones[i].overflow,
                                  clones[i].inconsistency), 5)
    del clones
    pclones = [clone(base) for _ in range(3)]
    ms16_plain = timer(lambda i: top_n.pool_apply_plain(
        pclones[i].rows, pclones[i].valid, pclones[i].row_hash, left, S), 2)
    del pclones
    a, bb = clone(base), to_cpu(base)
    pool_k(a.rows, a.valid, a.row_hash, left, S, a.overflow, a.inconsistency)
    _, _, _, n_over, n_miss = top_n.pool_apply_plain(
        bb.rows, bb.valid, bb.row_hash, chunk_to(left, cpu), S)
    bb.overflow.add_(n_over)
    bb.inconsistency.add_(n_miss)
    _state_equal("topn_pool on the dynamic filter's left input", a, bb)
    lrow = sum(row_bytes(c) for c in left.columns)
    scanned = claimed_prefix(torch, (base.valid, base.row_hash,
                                     base.overflow),
                             (a.valid, a.row_hash, a.overflow), S)
    b16 = pool_apply_bound(left.capacity, lrow, n_del, n_ins, scanned)
    print(f"[topn_pool] on the dynamic filter's left input, the "
          f"aggregation's flush of {left.capacity} rows ({n_del} deletes, "
          f"{n_ins} inserts) into a pool of {S} ({int(base.valid.sum())} "
          f"live): exact; kernel {ms16:.4f} ms, plain {ms16_plain:.4f} ms, "
          f"bound {b16[0]:.5f} ms", flush=True)
    pool_extra = {"dyn_filter_input": dict(
        rows=left.capacity, deletes=n_del, inserts=n_ins, ms=ms16,
        plain_ms=ms16_plain, bound_ms=b16[0], bound_by=b16[1])}
    fc = dex.filter_col
    v = left.column(fc)
    mk = df.pass_mask_cuda if cuda else df.pass_mask_plain
    pm_k = mk(v, left.valid, base.threshold, base.has_threshold, dex.cmp)
    pm_p = df.pass_mask_plain(v.cpu(), left.valid.cpu(), base.threshold.cpu(),
                              base.has_threshold.cpu(), dex.cmp)
    err = max_abs_err(torch, [("dyn_filter left", pm_k, pm_p.to(device))])
    lms = timer(lambda i: mk(v, left.valid, base.threshold,
                             base.has_threshold, dex.cmp), 200)
    lplain = timer(lambda i: df.pass_mask_plain(
        v, left.valid, base.threshold, base.has_threshold, dex.cmp), 50)
    # each row's flag read and mask written, the valid rows' values read
    n_left = int(left.valid.sum())
    lb = bound(left.capacity * 2 + n_left * v.element_size(),
               left.capacity + n_left * 2)

    # -- K21's right pass: the threshold up, down, emptied, set again -----
    thr0 = int(base.threshold)
    rschema = job.nodes[5].fragment.executors[-1].out_schema
    rcap = 2 * gex.emit_capacity
    # up past the median passing value (the rows below it retract), down
    # to the largest failing value (those rows come in)
    vals = base.rows[fc][base.valid].cpu().numpy()
    above, below = vals[vals >= thr0], vals[vals < thr0]
    up = int(np.median(above)) + 1 if above.size else thr0 + 1
    down = int(below.max()) if below.size else max(thr0 - 1, 0)
    script = [("up", [thr0, up], [2, 3]), ("down", [up, down], [2, 3]),
              ("emptied", [down], [1]), ("set", [thr0], [0])]
    sk_, sp_ = clone(base), to_cpu(base)
    band_k = df.band_cuda if cuda else df.band_plain
    bands = {}
    pairs = []
    for tag, vals, ops in script:
        rc = chunk_to(_rhs_chunk(torch, rschema, rcap, vals, ops), device)
        rp = chunk_to(rc, cpu)
        ok_, ek_ = band_k(sk_.rows[fc], sk_.valid, rc.column(0), rc.ops,
                          rc.valid, sk_.threshold, sk_.has_threshold,
                          dex.cmp)
        op_, ep_ = df.band_plain(sp_.rows[fc], sp_.valid, rp.column(0),
                                 rp.ops, rp.valid, sp_.threshold,
                                 sp_.has_threshold, dex.cmp)
        pairs += [(f"dyn_filter {tag} valid", ek_, ep_.to(device)),
                  (f"dyn_filter {tag} ops", torch.where(ek_, ok_, 0),
                   torch.where(ep_, op_, 0).to(device)),
                  (f"dyn_filter {tag} threshold", sk_.threshold.clone(),
                   sp_.threshold.to(device, copy=True)),
                  (f"dyn_filter {tag} has", sk_.has_threshold.clone(),
                   sp_.has_threshold.to(device, copy=True))]
        bands[tag] = int(ep_.sum())
    err = max(err, max_abs_err(torch, pairs))
    if not (bands["up"] and bands["down"] and bands["emptied"]):
        fail(f"dyn_filter: a threshold move emitted no band {bands}")
    # every comparison on int64, and ge on int32 and float64 (NUMERIC and
    # TIMESTAMP are int64), over a synthetic pool of the same size: the
    # threshold set, raised, dropped and emptied
    g = torch.Generator(device="cpu").manual_seed(102)
    pairs = []
    kinds = [(c, torch.int64) for c in ("gt", "ge", "lt", "le", "eq")] \
        + [("ge", torch.int32), ("ge", torch.float64)]
    for cmp_, dt in kinds:
        vals = torch.randint(0, 64, (S,), generator=g).to(dt)
        pvalid = torch.rand(S, generator=g) < 0.5
        sp = [vals, pvalid, torch.zeros((), dtype=dt),
              torch.zeros((), dtype=torch.bool)]
        sk = [x.to(device, copy=True) for x in sp]
        for step, (rv, rops) in enumerate((([20], [0]), ([20, 40], [2, 3]),
                                           ([40, 8], [2, 3]), ([8], [1]))):
            rhs = torch.tensor(rv, dtype=dt)
            rop = torch.tensor(rops, dtype=torch.int8)
            rval = torch.ones(len(rv), dtype=torch.bool)
            ok_, ek_ = band_k(*sk[:2], rhs.to(device), rop.to(device),
                              rval.to(device), *sk[2:], cmp_)
            op_, ep_ = df.band_plain(*sp[:2], rhs, rop, rval, *sp[2:], cmp_)
            tag = f"dyn_filter {cmp_} {dt} step {step}"
            pairs += [(f"{tag} valid", ek_, ep_.to(device)),
                      (f"{tag} ops", torch.where(ek_, ok_, 0),
                       torch.where(ep_, op_, 0).to(device)),
                      (f"{tag} threshold", sk[2].clone(),
                       sp[2].to(device, copy=True))]
            pairs.append((f"{tag} left", mk(*sk, cmp_),
                          df.pass_mask_plain(*sp, cmp_).to(device)))
    err = max(err, max_abs_err(torch, pairs))
    rcs = [chunk_to(_rhs_chunk(torch, rschema, rcap, vals, ops), device)
           for vals, ops in (([down, up], [2, 3]), ([up, down], [2, 3]))]
    tk_ = clone(base)
    tk_.threshold.fill_(down)
    rms = timer(lambda i: band_k(tk_.rows[fc], tk_.valid,
                                 rcs[i % 2].column(0), rcs[i % 2].ops,
                                 rcs[i % 2].valid, tk_.threshold,
                                 tk_.has_threshold, dex.cmp), 200)
    rplain = timer(lambda i: df.band_plain(
        tk_.rows[fc], tk_.valid, rcs[i % 2].column(0), rcs[i % 2].ops,
        rcs[i % 2].valid, tk_.threshold, tk_.has_threshold, dex.cmp), 20)
    # from the elements the work needs: each slot's flag read and band
    # flag written, the live slots' values read, the band rows' ops
    # written; the right chunk's flags read, its visible rows' ops and
    # values.  The timed moves go down -> up -> down: one band size.
    live = int(base.valid.sum())
    tp_ = to_cpu(base)
    tp_.threshold.fill_(down)
    rp0 = chunk_to(rcs[0], cpu)
    _, ep0 = df.band_plain(tp_.rows[fc], tp_.valid, rp0.column(0), rp0.ops,
                           rp0.valid, tp_.threshold, tp_.has_threshold,
                           dex.cmp)
    n_band, n_rhs = int(ep0.sum()), int(rp0.valid.sum())
    vsz = tk_.rows[fc].element_size()
    rb = bound(S * 2 + live * vsz + n_band + rcap + n_rhs * (1 + vsz),
               S + live * 4 + rcap)
    print(f"[dyn_filter] exact (right: threshold {thr0} -> {up} -> {down} "
          f"-> emptied -> {thr0} over a pool of {S} ({live} live): bands "
          f"{bands}; left: the aggregation's flush of {left.capacity} rows; "
          f"gt/ge/lt/le/eq on int64, ge on int32 and float64 over a "
          f"synthetic pool of {S}); "
          f"kernel {rms:.4f} ms on the right (threshold moves, bands of "
          f"{n_band}), plain "
          f"{rplain:.4f} ms, bound {rb[0]:.5f} ms; left {lms:.4f} ms, plain "
          f"{lplain:.4f} ms, bound {lb[0]:.6f} ms", flush=True)
    out["dyn_filter"] = kernel_entry(
        "dyn_filter.cu", "risingwave_tpu/stream/dynamic_filter.py:106", rms,
        rplain, rb, None, err)
    out["dyn_filter"].update(band_rows=n_band, left_valid=n_left,
                             left_ms=lms, left_plain_ms=lplain,
                             left_bound_ms=lb[0], left_bound_by=lb[1],
                             bands=bands, pool_live=live)
    del eng, job, states, base, sk_, sp_, tk_, a, bb, gk, gp
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out, preagg_extra, pool_extra


def _leaves_of(col) -> list:
    from risingwave_tpu_torch.common.tree import flatten

    return flatten(col)[0]


def check_q102(eng, cap: int) -> str:
    """The MV equals numpy over the consumed events: each auction's
    joined bid count, kept where it is at least the floor division of
    all bids (the second reader's) by their distinct auctions."""
    import numpy as np

    job = eng.jobs[0]
    ra, rb, rbid = (job.sources[n] for n in ("a", "b", "bid"))

    def gen(r):
        return getattr(r, "inner", r).gen

    aid, (aname, alens), _ = _consumed_wm(
        lambda i: gen(ra).gen_auctions(i * cap, cap,
                                       JOIN_AUCTION_COLS).columns,
        ra.offset // cap)
    bauc, _ = _consumed_wm(
        lambda i: [gen(rb).gen_bids(i * cap, cap).columns[j]
                   for j in (0, 5)], rb.offset // cap)
    sauc, _ = _consumed_wm(
        lambda i: [gen(rbid).gen_bids(i * cap, cap).columns[j]
                   for j in (0, 5)], rbid.offset // cap)
    if np.unique(aid).shape[0] != aid.shape[0]:
        fail("q102 check: an auction id appears twice")
    thr = sauc.shape[0] // max(np.unique(sauc).shape[0], 1)
    sa = np.sort(bauc, kind="stable")
    counts = np.searchsorted(sa, aid, "right") - np.searchsorted(sa, aid,
                                                                 "left")
    keep = (counts > 0) & (counts >= thr)
    want_id, want_n = aid[keep], counts[keep]
    want_name = _name_key(aname[keep], alens[keep])
    entry = eng.catalog.get("nexmark_q102")
    mv = job.states[entry.mv_state_index[0]][entry.mv_state_index[1]]
    occ = mv.table.occupied
    got_id = mv.values[0][occ].cpu().numpy()
    got_name = _name_key(mv.values[1].data[occ].cpu().numpy(),
                         mv.values[1].lens[occ].cpu().numpy())
    got_n = mv.values[2][occ].cpu().numpy()
    o, w = np.argsort(got_id), np.argsort(want_id)
    if got_id.shape != want_id.shape or not (
            np.array_equal(got_id[o], want_id[w])
            and np.array_equal(got_name[o], want_name[w])
            and np.array_equal(got_n[o], want_n[w])):
        fail(f"q102 MV ({got_id.shape[0]} rows) differs from numpy "
             f"({want_id.shape[0]} auctions at threshold {thr})")
    thr_dev = int(job.states[6].threshold)
    if thr_dev != thr:
        fail(f"q102 threshold {thr_dev} differs from numpy's {thr}")
    return (f"MV equals numpy over {aid.shape[0]} auctions, "
            f"{bauc.shape[0]} joined-side and {sauc.shape[0]} scalar-side "
            f"bids: threshold {thr} = {sauc.shape[0]} bids // "
            f"{np.unique(sauc).shape[0]} auctions, {int((counts > 0).sum())} "
            f"auctions with bids, {want_id.shape[0]} rows kept")


def phase_q102_main_path(torch, device, scale):
    """q102 at the slice's sizes: 9 warm-up barriers, then 32 timed
    barriers of 8 rounds (an auction chunk and a chunk from each of the
    two bid readers) with the launch counters and host reads taken over
    the timed window; the loss counters audited (0), the spill rings
    empty, the MV and the threshold checked with numpy."""
    from risingwave_tpu_torch import kernels

    cuda = device.type == "cuda"
    barriers = BARRIERS if cuda else 2
    eng = _join_engine(torch, device, scale, "q102",
                       WARMUP_BARRIERS if cuda else 1, over=_q102_over(scale))
    job = eng.jobs[0]
    if cuda:
        torch.cuda.synchronize()
    kernels.reset_launches()
    reads0 = (job.window_reads, job.barrier_reads, job.spill_reads)
    t0 = time.perf_counter()
    eng.tick(barriers=barriers, chunks_per_barrier=CHUNKS_PER_BARRIER)
    if cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    cap = job.sources["a"].cap
    chunks = barriers * CHUNKS_PER_BARRIER * 3
    rows = chunks * cap
    reads = (job.window_reads - reads0[0], job.barrier_reads - reads0[1],
             job.spill_reads - reads0[2])
    rate = rows / dt
    print(f"[main] q102 {rows} rows (auctions and both bid readers' rows) "
          f"in {dt:.3f} s = {rate:.0f} rows/s; host reads: {reads[0]} "
          f"emission totals, {reads[2]} spill counts = "
          f"{sum(reads) / chunks:.3f} per chunk; port kernel launches "
          f"{sum(launches.values()) / chunks:.2f} per chunk {launches}",
          flush=True)
    if cuda:
        per_chunk = profile_window(torch, eng, "q102", barriers=1,
                                   chunks_per_barrier=3 * CHUNKS_PER_BARRIER)
        print(f"[main] q102 launches per chunk "
              f"{'not measured' if per_chunk is None else f'{per_chunk:.1f}'}"
              f" (all CUDA kernels, profiled window)", flush=True)
    eng.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1")
    try:
        eng.tick(barriers=1, chunks_per_barrier=0)
    except RuntimeError as e:
        fail(f"q102: the counter audit raised: {e}")
    st = job.states
    js, agg, glob, dyn = st[2], st[3][0], st[5][0], st[6]
    counters = {"join left overflow": js.left.overflow,
                "join right overflow": js.right.overflow,
                "join left inconsistency": js.left.inconsistency,
                "join right inconsistency": js.right.inconsistency,
                "emit_overflow": js.emit_overflow,
                "agg overflow": agg.overflow, "agg spill ring":
                agg.spill_count, "global agg overflow (dedup included)":
                glob.overflow, "global agg inconsistency (dedup included)":
                glob.inconsistency, "global agg spill ring":
                glob.spill_count, "filter overflow": dyn.overflow,
                "filter inconsistency": dyn.inconsistency,
                "late auctions": st[0][0].late_rows,
                "late bids": st[1][0].late_rows,
                "late scalar-side bids": st[4][0].late_rows}
    vals = {k: int(v) for k, v in counters.items()}
    absorbed = [t.rows_absorbed for _, t in job._spill_tiers.values()]
    if any(vals.values()) or any(absorbed):
        fail(f"q102: loss counters {vals}, tier rows {absorbed}")
    print(f"[check] q102 overflow and inconsistency 0 (join, both aggs and "
          f"their dedup, the filter), spill rings empty, no late rows; "
          f"dedup table {int(glob.distinct_tables[0].occupied.sum())} keys, "
          f"filter pool {int(dyn.valid.sum())} rows, threshold "
          f"{int(dyn.threshold)}", flush=True)
    print(f"[check] q102 {check_q102(eng, cap)}", flush=True)
    del eng, job, st, js, agg, glob, dyn
    if cuda:
        torch.cuda.empty_cache()
    return launches, rate


# ---------------------------------------------------------------------------
# q22, q10, q21: string and calendar expressions (K23a-d)


#: RisingWave's Nexmark q22 and q21 views, and q10's projection, as
#: published (q10 without Flink's filesystem sink)
STRING_QUERY_SQL = {
    "q22": """
CREATE MATERIALIZED VIEW nexmark_q22 AS
SELECT auction, bidder, price, channel,
    SPLIT_PART(url, '/', 4) as dir1,
    SPLIT_PART(url, '/', 5) as dir2,
    SPLIT_PART(url, '/', 6) as dir3 FROM bid;
""",
    "q10": """
CREATE MATERIALIZED VIEW nexmark_q10 AS
SELECT auction, bidder, price, date_time,
    TO_CHAR(date_time, 'YYYY-MM-DD') as date,
    TO_CHAR(date_time, 'HH:MI') as time FROM bid;
""",
    "q21": """
CREATE MATERIALIZED VIEW nexmark_q21 AS
SELECT
    auction, bidder, price, channel,
    CASE
        WHEN lower(channel) = 'apple' THEN '0'
        WHEN lower(channel) = 'google' THEN '1'
        WHEN lower(channel) = 'facebook' THEN '2'
        WHEN lower(channel) = 'baidu' THEN '3'
        ELSE (regexp_match(url, '(&|^)channel_id=([^&]*)'))[2]
        END
    AS channel_id FROM bid
    where (regexp_match(url, '(&|^)channel_id=([^&]*)'))[2] is not null or
          lower(channel) in ('apple', 'google', 'facebook', 'baidu');
""",
}
STRING_QUERIES = tuple(STRING_QUERY_SQL)
#: the K23 kernels' names in ``kernels.KERNELS``
K23_KERNELS = ("str_split_part", "to_char", "regexp_group", "str_cmp",
               "str_case_map")
#: hand-picked strings of the K23 edge cases (40 B wide, as bid.url):
#: split_part's greedy overlaps ('aa' in 'aaaa' is 2 matches), empty and
#: delimiter-only strings, the regexp's guard at offset 0, after '&',
#: after another byte (fails), with and without a stop byte, an empty
#: capture, two candidates; bytes >= 128 for the unsigned compare
K23_STRINGS = (b"", b"/", b"//", b"aaaa", b"aaa", b"a/b/c", b"/a/b/",
               b"https://nexmark.io/page1/item", b"channel_id=abc",
               b"x&channel_id=abc&y=1", b"xchannel_id=abc", b"channel_id=",
               b"&channel_id=", b"a&channel_id=xyz", b"channel_id=&q",
               b"channel_id=1&channel_id=2", b"&&channel_id=&",
               b"q=1&xchannel_id=9&channel_id=7", b"channel_id",
               b"APPLE", b"Google", b"\x80\xffAZaz[@`{", b"x" * 40,
               b"aa/aa//aaa" * 4)
#: tokens of the random strings
K23_TOKENS = (b"channel_id=", b"&", b"x", b"aa", b"/", b"=", b"A", b"z",
              b"\xff", b"ab/")
#: delimiters of split_part's per-row delimiter column (8 B wide)
K23_DELIMS = (b"/", b"aa", b"", b"&", b"ab/", b"=", b"/a", b"xxxxxxxx")
DAY_US = 86_400_000_000
#: hand-picked timestamps: day and noon boundaries on both sides of the
#: epoch, years 0, -1, 9999 and 10000 and past, the int64 extremes
K23_TIMESTAMPS = (0, -1, 1, DAY_US - 1, DAY_US, -DAY_US, -DAY_US - 1,
                  -DAY_US + 1, 43_200_000_000, 43_199_999_999,
                  -43_200_000_000, 1_436_918_400_000_000,
                  253_402_300_799_999_999, 253_402_300_800_000_000,
                  -62_167_219_200_000_000, -62_167_219_200_000_001,
                  -62_198_755_200_000_000, 10**17, -10**17,
                  2**63 - 1, -2**63)


def k23_cases(n: int, seed: int = 23) -> dict:
    """``n`` rows of K23 edge cases as numpy arrays: ``strs`` (40 B
    wide, the hand-picked ones first, then random token strings; a
    quarter of the rows carry non-zero bytes past their length, which no
    function may read), ``other`` (the comparisons' right side: copies,
    prefixes, extensions and random strings), ``delims`` (8 B wide) and
    ``nth`` (split_part's per-row delimiter and part number, extremes
    included), and ``ts`` (int64 microseconds: the hand-picked ones,
    then uniform over +-400 years)."""
    import numpy as np

    from risingwave_tpu_torch.common.chunk import encode_strings

    rng = np.random.default_rng(seed)

    def random_string():
        s = b"".join(K23_TOKENS[k] for k in
                     rng.integers(0, len(K23_TOKENS), rng.integers(0, 12)))
        return s[:int(rng.integers(0, 41))]

    strs = [K23_STRINGS[i] if i < len(K23_STRINGS) else random_string()
            for i in range(n)]
    other = []
    for s in strs:
        kind = rng.integers(0, 4)
        if kind == 0:
            other.append(s)
        elif kind == 1:
            other.append(s[:int(rng.integers(0, len(s) + 1))])
        elif kind == 2:
            other.append(s + random_string()[:4])
        else:
            other.append(random_string())
    data, lens = encode_strings(strs, 40)
    garbage = rng.integers(1, 256, data.shape).astype(np.uint8)
    past = np.arange(40)[None, :] >= lens[:, None]
    dirty = (rng.random(n) < 0.25)[:, None] & past
    data = np.where(dirty, garbage, data)
    o_data, o_lens = encode_strings(other, 40)
    delims = [K23_DELIMS[k] for k in rng.integers(0, len(K23_DELIMS), n)]
    delims[:4] = [b"aa", b"aa", b"/", b"/"]
    d_data, d_lens = encode_strings(delims, 8)
    nth = rng.integers(-7, 8, n).astype(np.int32)
    nth[:8] = (2, -1, 0, 7, -7, 2**31 - 1, -2**31, 1)
    span = 400 * 365 * DAY_US
    ts = rng.integers(-span, span, n, dtype=np.int64)
    k = min(n, len(K23_TIMESTAMPS))
    ts[:k] = np.array(K23_TIMESTAMPS[:k], np.int64)
    return {"strs": (data, lens), "other": (o_data, o_lens),
            "delims": (d_data, d_lens), "nth": nth, "ts": ts}


#: K23e's patterns: greedy overlaps ('aa' in 'aaa' is one match), an
#: empty ``from`` (the row is copied), a ``to`` longer than ``from`` (rows
#: near their full width truncate at it), ``from`` longer than the string
K23E_FROM = (b"e", b"aa", b"", b"/", b"x", b"ab/", b"channel=", b"&")
K23E_TO = (b"", b"yy", b"Z", b"12345678", b"-", b"aa")
#: K23f's LIKE patterns (no '_'): anchored and unanchored ends, a lone and
#: a doubled '%', the last anchored segment overlapping the first ('aa%aa'
#: on 'aaa'), interior segments in order, q14's bid_strings pattern
K23F_LIKE = ("https://%page1%item", "%", "%%", "a%", "%a", "a%b", "aa%aa",
             "%a%b%", "x%x%x", "chan%=%&%", "a%%b", "%/%/%", "%aa%aa%",
             "/%", "%&%=", "ab/%ab/", "aaaa", "%z", "x%")
#: K23g's strings around spaces: leading, trailing, inner and only spaces
K23G_STRINGS = (b"", b" ", b"   ", b" a", b"a ", b" a b ", b"  ab  cd  ",
                b"hello", b" " * 40, b"x" * 40, b" " + b"y" * 38 + b" ")
#: K23g's substr windows (start, count; None: no count): PostgreSQL's
#: non-positive starts (substr('hello', -1, 3) = 'h'), negative counts,
#: windows past the end, int32's extremes
K23G_WINDOWS = ((-1, 3), (0, 2), (1, 0), (1, 5), (3, None), (41, 5),
                (2, -3), (-5, 10), (-2**31, 2**31 - 1), (2**31 - 1, 5),
                (1, None), (0, None), (-3, None), (40, 1))
#: K23h's timestamps: year boundaries from 1600 to 2400 on both sides of
#: midnight, leap days (2000-02-29, 2100-02-28 / 03-01), 1969-12-31's last
#: microsecond, and K23b's hand-picked ones
K23H_TIMESTAMPS = (-11_676_096_000_000_000, -11_676_096_000_000_001,
                   -2_208_988_800_000_000, -2_208_988_800_000_001, -1,
                   951_782_400_000_000, 951_868_799_999_999,
                   4_107_456_000_000_000, 4_107_542_399_999_999,
                   13_569_465_600_000_000, 13_569_465_599_999_999,
                   1_436_918_400_000_000, 1_436_947_200_000_000,
                   1_436_961_600_000_000)


def k23_rest_cases(n: int, seed: int = 231) -> dict:
    """``n`` rows of K23e-h edge cases as numpy arrays: ``strs`` and
    ``other`` (``k23_cases``': 40 B wide, bytes past a quarter of the
    lengths), ``frm`` and ``to`` (replace's per-row patterns, 8 B wide),
    ``pats`` (the match functions' per-row patterns, 8 B wide: copies,
    prefixes and suffixes of the row, and longer ones), ``spaced`` (40 B
    strings around spaces for trim), ``start`` / ``count`` (substr's
    per-row windows, int64, the hand-picked ones first), ``ts`` (int64
    microseconds from 1600 to 2400 with the hand-picked ones first) and
    ``days`` (int32 dates over +-2^26 days)."""
    import numpy as np

    from risingwave_tpu_torch.common.chunk import encode_strings

    rng = np.random.default_rng(seed)
    base = k23_cases(n, seed)
    sd, sl = base["strs"]
    frm = [K23E_FROM[k] for k in rng.integers(0, len(K23E_FROM), n)]
    to = [K23E_TO[k] for k in rng.integers(0, len(K23E_TO), n)]
    frm[:4], to[:4] = [b"x", b"x", b"aa", b""], [b"yy", b"12345678", b"b",
                                                   b""]
    pats = []
    for i in range(n):
        s = bytes(sd[i, :sl[i]])
        kind = rng.integers(0, 5)
        k = int(rng.integers(0, min(len(s), 8) + 1))
        if kind == 0:
            pats.append(s[:k])
        elif kind == 1:
            pats.append(s[len(s) - k:])
        elif kind == 2:
            j = int(rng.integers(0, max(len(s) - k, 0) + 1))
            pats.append(s[j:j + k])
        elif kind == 3:
            pats.append(K23E_FROM[int(rng.integers(0, len(K23E_FROM)))])
        else:
            pats.append(b"z" * int(rng.integers(0, 9)))
    tokens = (b" ", b"  ", b"a", b"bc", b"\xff", b"x y")
    spaced = [K23G_STRINGS[i] if i < len(K23G_STRINGS) else
              b"".join(tokens[t] for t in
                       rng.integers(0, len(tokens), rng.integers(0, 14)))[:40]
              for i in range(n)]
    start = rng.integers(-6, 46, n).astype(np.int64)
    count = rng.integers(-4, 46, n).astype(np.int64)
    k = min(n, len(K23G_WINDOWS))
    start[:k] = [w[0] for w in K23G_WINDOWS[:k]]
    count[:k] = [w[1] if w[1] is not None else 2**40
                 for w in K23G_WINDOWS[:k]]
    lo, hi = -11_676_096_000_000_000, 13_569_465_600_000_000
    ts = rng.integers(lo, hi, n, dtype=np.int64)
    hand = K23H_TIMESTAMPS + K23_TIMESTAMPS
    k = min(n, len(hand))
    ts[:k] = np.array(hand[:k], np.int64)
    days = rng.integers(-2**26, 2**26, n).astype(np.int32)
    days[:6] = (0, -1, 1, -719_528, 2**26, -2**26)
    enc = lambda xs, w: encode_strings(xs, w)  # noqa: E731
    return {"strs": base["strs"], "other": base["other"],
            "frm": enc(frm, 8), "to": enc(to, 8), "pats": enc(pats, 8),
            "spaced": enc(spaced, 40), "start": start, "count": count,
            "ts": ts, "days": days}


def k23_python_like(s: bytes, pattern: str) -> bool:
    """LIKE by Python's ``re`` (``%`` is ``.*``, everything else
    literal): the oracle of K23f's LIKE."""
    import re

    rx = b".*".join(re.escape(x) for x in pattern.encode().split(b"%"))
    return re.fullmatch(rx, s, re.S) is not None


def k23_python_split(s: bytes, d: bytes, n: int) -> bytes:
    """split_part by Python's ``bytes.split`` (leftmost non-overlapping,
    as PostgreSQL's; an empty delimiter leaves the string whole; n = 0,
    which SQL refuses, and parts out of range are empty)."""
    parts = s.split(d) if d else [s]
    k = n - 1 if n > 0 else len(parts) + n
    return parts[k] if 0 <= k < len(parts) else b""


def _strcol(torch, device, pair):
    from risingwave_tpu_torch.common.chunk import StrCol

    return StrCol(torch.from_numpy(pair[0]).to(device),
                  torch.from_numpy(pair[1]).to(device))


def _literal_col(torch, device, value: bytes, cap: int, width: int = 64):
    """A literal as ``Literal.eval`` returns it: one row, stride 0."""
    from risingwave_tpu_torch.common.chunk import StrCol, encode_strings

    data, lens = encode_strings([value], width)
    return StrCol(torch.from_numpy(data).to(device).expand(cap, -1),
                  torch.from_numpy(lens).to(device).expand(cap))


def _compared_bytes(a, b) -> int:
    """The bytes K23d's comparison reads over its rows: each row's
    positions up to and including the first difference (all of the
    longer length when equal)."""
    import numpy as np

    ad, bd = a.data.cpu().numpy(), b.data.cpu().numpy()
    la, lb = a.lens.cpu().numpy(), b.lens.cpu().numpy()
    w = max(ad.shape[1], bd.shape[1])
    idx = np.arange(w)[None, :]
    av = np.where(idx < la[:, None], np.pad(ad, ((0, 0), (0, w - ad.shape[1])))
                  .astype(np.int16), -1)
    bv = np.where(idx < lb[:, None], np.pad(bd, ((0, 0), (0, w - bd.shape[1])))
                  .astype(np.int16), -1)
    neq = av != bv
    m = np.maximum(la, lb)
    k = np.where(neq.any(axis=1), neq.argmax(axis=1) + 1, m)
    return int(np.minimum(k, m).sum())


def _str_pairs(tag, a, b, found=None):
    pairs = [(f"{tag} bytes", a[0].data, b[0].data),
             (f"{tag} lens", a[0].lens, b[0].lens)]
    if found is not None:
        pairs.append((f"{tag} found", a[1], b[1]))
    return pairs


def phase_string_kernels(torch, device, timer, scale):
    """K23a-d against their plain versions on the card, exactly: on 8192
    edge-case rows (``k23_cases``: bytes, lengths and the regexp's found
    flags) and on a bid chunk at the main paths' shapes (url 40 B,
    channel 16 B, a 64 B literal of stride 0), which also times each
    kernel, its plain version and the bound of the bytes its rows need."""
    from risingwave_tpu_torch.connector.nexmark import NexmarkGenerator
    from risingwave_tpu_torch.expr import scalar
    from risingwave_tpu_torch.expr import strings as S

    cap = 8192 // scale
    cases = k23_cases(cap)
    strs = _strcol(torch, device, cases["strs"])
    other = _strcol(torch, device, cases["other"])
    delims = _strcol(torch, device, cases["delims"])
    nth = torch.from_numpy(cases["nth"]).to(device)
    ts = torch.from_numpy(cases["ts"]).to(device)
    bids = NexmarkGenerator(device=device).gen_bids(0, cap)
    channel, url, date_time = bids.columns[3], bids.columns[4], \
        bids.columns[5]
    lit = {v: _literal_col(torch, device, v, cap)
           for v in (b"/", b"apple", b"channel_id=abc")}
    n_lit = {v: torch.full((cap,), v, dtype=torch.int32, device=device)
             for v in (4, 5, 6, -1, 0)}
    out = {}

    # -- K23d str_cmp: the six comparisons, columns and literal sides ----
    pairs = []
    for op in S.CMP_OPS:
        for tag, a, b in (("columns", strs, other),
                          ("literal right", strs, lit[b"channel_id=abc"]),
                          ("literal left", lit[b"apple"], strs),
                          ("q21", S.str_case_map(channel, False),
                           lit[b"apple"])):
            pairs.append((f"str_cmp {op} {tag}", S.str_cmp(a, b, op),
                          S.str_cmp_plain(a, b, op)))
    err = max_abs_err(torch, pairs)
    low = S.str_case_map(channel, False)
    ms = timer(lambda i: S.str_cmp(low, lit[b"apple"], "eq"), 200)
    plain_ms = timer(lambda i: S.str_cmp_plain(low, lit[b"apple"], "eq"), 20)
    # per row: the bytes compared up to the first difference, both
    # lengths, the result; the literal's row once
    n_cmp = _compared_bytes(low, lit[b"apple"])
    b_ = bound(n_cmp + cap * 5 + 64 + 4, n_cmp * 4)
    print(f"[str_cmp] exact on {cap} edge-case rows (6 ops, columns and "
          f"stride-0 literals, bytes >= 128) and q21's lower(channel) = "
          f"'apple'; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{b_[0]:.5f} ms", flush=True)
    out["str_cmp"] = kernel_entry("str_cmp.cu",
                                  "risingwave_tpu/expr/scalar.py:241", ms,
                                  plain_ms, b_, None, err)

    # -- K23d str_case_map ------------------------------------------------
    pairs = []
    for upper in (False, True):
        for tag, a in (("edge cases", strs), ("channel", channel),
                       ("literal", lit[b"channel_id=abc"])):
            x, y = S.str_case_map(a, upper), S.str_case_map_plain(a, upper)
            pairs += _str_pairs(f"str_case_map {'upper' if upper else 'lower'}"
                                f" {tag}", (x,), (y,))
    err = max_abs_err(torch, pairs)
    ms = timer(lambda i: S.str_case_map(channel, False), 200)
    plain_ms = timer(lambda i: S.str_case_map_plain(channel, False), 20)
    w = channel.data.shape[1]
    b_ = bound(2 * cap * w, cap * w * 3)
    print(f"[str_case_map] exact (lower and upper over edge cases with "
          f"bytes past the lengths, the channel column, a literal); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_[0]:.5f} ms",
          flush=True)
    out["str_case_map"] = kernel_entry("str_cmp.cu",
                                       "risingwave_tpu/expr/scalar.py:438",
                                       ms, plain_ms, b_, None, err)

    # -- K23a str_split_part ----------------------------------------------
    pairs = []
    cases_run = [("per-row delimiters and n", strs, delims, nth)]
    cases_run += [(f"'/' n={k}", strs, lit[b"/"], n_lit[k])
                  for k in (4, 5, 6, -1, 0)]
    cases_run += [(f"url n={k}", url, lit[b"/"], n_lit[k]) for k in (4, 5, 6)]
    for tag, a, d, k in cases_run:
        pairs += _str_pairs(f"split_part {tag}", (S.str_split_part(a, d, k),),
                            (S.str_split_part_plain(a, d, k),))
    err = max_abs_err(torch, pairs)
    got = S.str_split_part(strs, delims, nth)
    gd, gl = got.data.cpu().numpy(), got.lens.cpu().numpy()
    sd, sl = cases["strs"]
    dd, dl = cases["delims"]
    for i in range(cap):
        want = k23_python_split(bytes(sd[i, :sl[i]]), bytes(dd[i, :dl[i]]),
                                int(cases["nth"][i]))
        if bytes(gd[i, :gl[i]]) != want or gd[i, gl[i]:].any():
            fail(f"split_part row {i}: {bytes(gd[i, :gl[i]])!r} vs Python "
                 f"{want!r}")
    ms = timer(lambda i: S.str_split_part(url, lit[b"/"], n_lit[4]), 200)
    plain_ms = timer(lambda i: S.str_split_part_plain(url, lit[b"/"],
                                                      n_lit[4]), 10,
                     prefill_ms=10.0)
    ul = int(url.lens.sum())
    b_ = bound(ul + cap * 4 + 64 + 8 + cap * (url.data.shape[1] + 4),
               2 * ul * 4)
    print(f"[str_split_part] exact on {cap} edge-case rows (per-row "
          f"delimiters and n, greedy overlaps, empty delimiters, n out of "
          f"range both ways) and q22's split_part(url, '/', 4|5|6), equal "
          f"to Python's bytes.split; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b_[0]:.5f} ms", flush=True)
    out["str_split_part"] = kernel_entry(
        "str_split.cu", "risingwave_tpu/expr/scalar.py:748", ms, plain_ms,
        b_, None, err)

    # -- K23b to_char -----------------------------------------------------
    fmts = ("YYYY-MM-DD", "HH:MI", "HH24:MI:SS.MS", "yy/mm/dd US",
            "hh12 am PM", "yyyy-mm-dd hh24:mi:ss.us pm", "abc")
    pairs = []
    for f in fmts:
        segs = scalar.compile_to_char_pattern(f)
        for tag, t in (("edge cases", ts), ("date_time", date_time)):
            pairs += _str_pairs(f"to_char {f!r} {tag}",
                                (S.to_char(t, segs),),
                                (S.to_char_plain(t, segs),))
    err = max_abs_err(torch, pairs)
    segs = scalar.compile_to_char_pattern("YYYY-MM-DD")
    ms = timer(lambda i: S.to_char(date_time, segs), 200)
    plain_ms = timer(lambda i: S.to_char_plain(date_time, segs), 20,
                     prefill_ms=3.0)
    b_ = bound(cap * (8 + 10), cap * 60)
    print(f"[to_char] exact on {cap} timestamps (+-400 years, day and noon "
          f"boundaries, years 0 and 10000, the int64 extremes) in "
          f"{len(fmts)} formats and on q10's date_time; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {b_[0]:.5f} ms", flush=True)
    out["to_char"] = kernel_entry("to_char.cu",
                                  "risingwave_tpu/expr/scalar.py:857", ms,
                                  plain_ms, b_, None, err)

    # -- K23c regexp_group --------------------------------------------------
    pairs = []
    n_found = {}
    for pat in ("(&|^)channel_id=([^&]*)", "(^|&)channel_id=([^&]*)",
                "channel_id=([^&]*)", "(&|^)a([^/]*)"):
        node = scalar.RegexpGroup(None, pat, 2)
        litb = torch.tensor(list(node.lit.encode()), dtype=torch.uint8,
                            device=device)
        guard = -1 if node.guard is None else ord(node.guard)
        for tag, s in (("edge cases", strs), ("url", url)):
            x = S.regexp_group(s, litb, guard, ord(node.stop))
            y = S.regexp_group_plain(s, litb, guard, ord(node.stop))
            pairs += _str_pairs(f"regexp_group {pat!r} {tag}", x, y, True)
            n_found[(pat, tag)] = int(x[1].sum())
    err = max_abs_err(torch, pairs)
    node = scalar.RegexpGroup(None, "(&|^)channel_id=([^&]*)", 2)
    litb = torch.tensor(list(node.lit.encode()), dtype=torch.uint8,
                        device=device)
    ms = timer(lambda i: S.regexp_group(url, litb, ord("&"), ord("&")), 200)
    plain_ms = timer(lambda i: S.regexp_group_plain(url, litb, ord("&"),
                                                    ord("&")), 20,
                     prefill_ms=3.0)
    # unmatched url rows (all of the main path's) read their whole string
    b_ = bound(ul + cap * 4 + len(node.lit) + cap * (url.data.shape[1] + 5),
               ul * len(node.lit))
    print(f"[regexp_group] exact on {cap} edge-case rows (guard at 0, after "
          f"'&', failing after another byte, unguarded, empty captures, "
          f"no stop byte; matches {n_found}) and on q21's url; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_[0]:.5f} ms",
          flush=True)
    out["regexp_group"] = kernel_entry(
        "str_regexp.cu", "risingwave_tpu/expr/scalar.py:1057", ms, plain_ms,
        b_, None, err)
    return out


def _string_engine(torch, device, scale, query: str, barriers: int):
    """``query`` in an engine at bench.py's sizes (chunk 8192, ring 2^23)
    after ``barriers`` barriers (maintenance off, a snapshot every 8
    checkpoints)."""
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig

    cfg = {k: v // scale for k, v in BENCH_CONFIG.items()}
    cfg["mv_ring_size"] = (1 << 23) // scale
    eng = Engine(PlannerConfig(**cfg), device=device)
    eng.execute(BENCH_SOURCES)
    eng.execute(STRING_QUERY_SQL[query])
    eng.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1000000")
    eng.execute("ALTER SYSTEM SET snapshot_interval_checkpoints = 8")
    eng.tick(barriers=barriers, chunks_per_barrier=CHUNKS_PER_BARRIER)
    return eng


def _consumed_bid_rows(eng, cap: int) -> dict:
    """Every bid the job consumed, regenerated: numpy auction, bidder,
    price, ts, and the channel and url strings as (bytes, lens)."""
    import numpy as np

    reader = eng.jobs[0].source
    cols = {k: [] for k in ("auction", "bidder", "price", "ts", "ch", "chl",
                            "url", "urll")}
    for i in range(reader.offset // cap):
        c = reader.gen.gen_bids(i * cap, cap).columns
        for k, x in (("auction", c[0]), ("bidder", c[1]), ("price", c[2]),
                     ("ts", c[5]), ("ch", c[3].data), ("chl", c[3].lens),
                     ("url", c[4].data), ("urll", c[4].lens)):
            cols[k].append(x.cpu().numpy())
    return {k: np.concatenate(v) for k, v in cols.items()}


def _ring_planes(eng, mv: str):
    """(row count, overflow, [leaf arrays]) of the MV's ring, in append
    order (no lap: the first ``cursor`` rows)."""
    from risingwave_tpu_torch.common.tree import flatten

    entry = eng.catalog.get(mv)
    state = eng.jobs[0].states[entry.mv_state_index[0]]
    n = int(state.cursor)
    leaves = [x[:n].cpu().numpy() for x in flatten(state.values)[0]]
    return n, int(state.overflow), leaves


def _expected_strings(keys, fn, width: int):
    """(bytes [n, width], lens [n]) of ``fn(key)`` per row, computed once
    per distinct key (rows of ``keys`` are [n, k] uint8 or int64 [n])."""
    import numpy as np

    from risingwave_tpu_torch.common.chunk import encode_strings

    keys = np.ascontiguousarray(keys)
    flat = keys.view(np.dtype((np.void, keys.dtype.itemsize
                               * (keys.shape[1] if keys.ndim > 1 else 1))))
    _, first, inv = np.unique(flat.reshape(-1), return_index=True,
                              return_inverse=True)
    data, lens = encode_strings([fn(keys[i]) for i in first], width)
    return data[inv.reshape(-1)], lens[inv.reshape(-1)]


def check_string_query(eng, query: str, cap: int) -> str:
    """The ring against numpy and Python over the consumed bids: the bid
    columns as consumed, and q22's url.split('/') parts 4-6 ('' past the
    end), q10's strftime('%Y-%m-%d') and '%I:%M', q21's four-way channel
    map with every row kept (no NULL): bytes with their zero tails,
    lengths and null planes exact."""
    import datetime as dt

    import numpy as np

    b = _consumed_bid_rows(eng, cap)
    n, overflow, leaves = _ring_planes(eng, f"nexmark_{query}")
    total = b["price"].shape[0]
    if n != total or overflow:
        fail(f"{query} ring holds {n} rows (overflow {overflow}) for "
             f"{total} bids")
    want = [b["auction"], b["bidder"], b["price"]]
    if query == "q22":
        want += [b["ch"], b["chl"]]
        keys = np.concatenate([b["url"], b["urll"][:, None].view(np.uint8)
                               .reshape(-1, 4)], axis=1)
        for part in (4, 5, 6):
            def fn(k, part=part):
                ln = int(k[40:].view(np.int32)[0])
                return k23_python_split(bytes(k[:ln]), b"/", part)
            want += list(_expected_strings(keys, fn, 40))
        what = "url.split('/') parts 4, 5 and 6"
    elif query == "q10":
        want.append(b["ts"])
        minute = b["ts"] // 60_000_000

        def fmt(pattern):
            def fn(m):
                t = dt.datetime(1970, 1, 1) + dt.timedelta(
                    microseconds=int(m) * 60_000_000)
                return t.strftime(pattern).encode()
            return fn
        want += list(_expected_strings(minute, fmt("%Y-%m-%d"), 10))
        want += list(_expected_strings(minute, fmt("%I:%M"), 5))
        what = "strftime('%Y-%m-%d') and strftime('%I:%M')"
    else:
        want += [b["ch"], b["chl"]]
        ids = {b"apple": b"0", b"google": b"1", b"facebook": b"2",
               b"baidu": b"3"}
        keys = np.concatenate([b["ch"], b["chl"][:, None].view(np.uint8)
                               .reshape(-1, 4)], axis=1)

        def fn(k):
            ln = int(k[16:].view(np.int32)[0])
            return ids[bytes(k[:ln]).lower()]
        d, ln = _expected_strings(keys, fn, 64)
        want += [d, ln, np.zeros(total, bool)]
        what = "the four-way channel map, every bid kept, no NULL"
    if len(want) != len(leaves):
        fail(f"{query} ring has {len(leaves)} leaves, expected {len(want)}")
    for i, (got, exp) in enumerate(zip(leaves, want)):
        if got.shape != exp.shape or not np.array_equal(got, exp):
            fail(f"{query} ring leaf {i} differs from numpy/Python")
    return (f"ring rows equal numpy/Python ({what}) over {n} bids, "
            f"{len(leaves)} leaves, no lap")


def phase_string_parity(torch, device, query: str) -> None:
    """``query`` at 2 events/s on the card and on the CPU (plain
    versions), small ring: the ring's rows and every state tensor must
    be equal."""
    from risingwave_tpu_torch.compat import state_mismatches, state_to_numpy
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig

    engines = []
    for dev in (device, torch.device("cpu")):
        eng = Engine(PlannerConfig(chunk_capacity=256, mv_ring_size=1 << 14),
                     device=dev)
        eng.execute(BENCH_SOURCES.replace("'1000000'", "'2'"))
        eng.execute(STRING_QUERY_SQL[query])
        eng.tick(barriers=6, chunks_per_barrier=4)
        engines.append(eng)
    rows = [e.execute(f"SELECT * FROM nexmark_{query}") for e in engines]
    if rows[0] != rows[1] or not rows[0]:
        fail(f"{query} ring on the card differs from the CPU plain versions")
    bad = state_mismatches(state_to_numpy(engines[1].jobs[0].states),
                           engines[0].jobs[0].states)
    if bad:
        fail(f"{query} state on the card differs from the CPU: {bad[:5]}")
    print(f"[parity] {query} at 2 events/s, 6 barriers: {len(rows[0])} ring "
          f"rows and all state equal to the CPU plain versions", flush=True)


def phase_string_main_path(torch, device, scale, query: str):
    """``query`` at bench.py's sizes: 9 warm-up barriers, then 32 timed
    barriers of 8 chunks with the launch counters taken over the timed
    window, one profiled window, the counter audit, and the ring checked
    with numpy and Python."""
    from risingwave_tpu_torch import kernels

    cuda = device.type == "cuda"
    barriers = BARRIERS if cuda else 2
    eng = _string_engine(torch, device, scale, query,
                         WARMUP_BARRIERS if cuda else 1)
    if cuda:
        torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    eng.tick(barriers=barriers, chunks_per_barrier=CHUNKS_PER_BARRIER)
    if cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    cap = eng.jobs[0].source.cap
    chunks = barriers * CHUNKS_PER_BARRIER
    rate = chunks * cap / dt
    k23 = {k: launches[k] / chunks for k in K23_KERNELS if launches[k]}
    print(f"[main] {query} {chunks * cap} rows in {dt:.3f} s = {rate:.0f} "
          f"rows/s; K23 launches per chunk {k23}; port kernel launches "
          f"{sum(launches.values()) / chunks:.2f} per chunk", flush=True)
    if cuda:
        per_chunk = profile_window(torch, eng, query)
        print(f"[main] {query} launches per chunk "
              f"{'not measured' if per_chunk is None else f'{per_chunk:.1f}'}"
              f" (all CUDA kernels, profiled window)", flush=True)
    eng.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1")
    eng.tick(barriers=1, chunks_per_barrier=0)
    print(f"[check] {query} {check_string_query(eng, query, cap)}",
          flush=True)
    del eng
    if cuda:
        torch.cuda.empty_cache()
    return launches, rate


# ---------------------------------------------------------------------------
# q13: tables, DML and the temporal join (K22a)


#: RisingWave's Nexmark q13 (``%`` for ``mod``: the reference's registry
#: has no ``mod``; the two agree on Nexmark's non-negative ids)
Q13_SQL = """
CREATE MATERIALIZED VIEW nexmark_q13 AS
SELECT B.auction, B.bidder, B.price, B.date_time, S.value
FROM bid B
{join} side_input FOR SYSTEM_TIME AS OF PROCTIME() S
ON B.auction % {keys} = S.key;
"""
Q13_KEYS = 10_000
#: UPDATEs and full-row DELETEs before each timed barrier of q13 churn
CHURN_UPDATES, CHURN_DELETES = 128, 16
STR_WIDTH = 64


def _q13_keys(scale: int) -> int:
    return Q13_KEYS // scale


def _q13_config(scale: int) -> dict:
    """bench.py's sizes, the ring at 2^23 (no lap) and the build table at
    ``join_table_size`` (2^14: 10,000 keys fill 61%)."""
    cfg = {k: v // scale for k, v in BENCH_CONFIG.items()}
    cfg.update(mv_ring_size=(1 << 23) // scale,
               join_table_size=(1 << 14) // scale)
    return cfg


def _side_input_sql(keys: int, retract: bool) -> list[str]:
    with_ = " WITH (retract = 'true')" if retract else ""
    out = [f"CREATE TABLE side_input (key BIGINT PRIMARY KEY, value VARCHAR)"
           f"{with_}"]
    for lo in range(0, keys, 1000):
        vals = ", ".join(f"({k}, '{k}')" for k in range(lo, min(lo + 1000,
                                                                 keys)))
        out.append(f"INSERT INTO side_input VALUES {vals}")
    return out


def _q13_ddl(scale: int, left: bool, sources: str = BENCH_SOURCES) -> list:
    keys = _q13_keys(scale)
    return [sources] + _side_input_sql(keys, retract=left) + [
        Q13_SQL.format(join="LEFT JOIN" if left else "JOIN", keys=keys),
        "ALTER SYSTEM SET maintenance_interval_checkpoints = 1000000",
        "ALTER SYSTEM SET snapshot_interval_checkpoints = 8"]


class Q13Churn:
    """The DML of q13 churn and its host model of ``side_input``.

    Before timed barrier ``t`` (its first bid at ordinal ``off``) it
    issues ``CHURN_UPDATES`` UPDATEs (fewer at a rehearsal's scale, so
    that a barrier's DML rows fit one chunk) of the live keys just after the
    newest auction id at the end of the barrier's first chunk (the bids
    of the chunks after it probe them: the first chunk is probed before
    the table reader's turn in the round), then ``CHURN_DELETES``
    full-row DELETEs of live keys 8 apart after the newest auction id at
    the end of the second chunk (later probes pad).  ``log`` keeps
    ``(bid ordinal from which the rows apply, {key: value or None})``."""

    def __init__(self, keys: int, cap: int, scale: int = 1):
        self.keys, self.cap = keys, cap
        # a barrier's DML rows (an UPDATE is two) fit the reader's chunk
        self.n_upd = max(CHURN_UPDATES // scale, 8)
        self.n_del = max(CHURN_DELETES // scale, 4)
        self.table = {k: str(k) for k in range(keys)}
        self.log: list = []

    @staticmethod
    def newest_auction(k: int) -> int:
        """The newest auction id when bid ordinal ``k`` is generated."""
        import torch

        from risingwave_tpu_torch.connector import nexmark as nx

        n = (k // nx.BID_PROPORTION) * nx.TOTAL_PROPORTION \
            + (nx.TOTAL_PROPORTION - nx.BID_PROPORTION) \
            + k % nx.BID_PROPORTION
        return int(nx._last_base0_auction_id(torch.tensor([n]))[0]) \
            + nx.FIRST_AUCTION_ID

    def sql(self, t: int, off: int) -> list[str]:
        out, change = [], {}
        a0 = self.newest_auction(off + self.cap - 1)
        k, n = a0 + 1, 0
        while n < self.n_upd and k < a0 + 1 + self.keys:
            key = k % self.keys
            k += 1
            if key in self.table and key not in change:
                change[key] = self.table[key] = f"u{t}_{key}"
                out.append(f"UPDATE side_input SET value = "
                           f"'{self.table[key]}' WHERE key = {key}")
                n += 1
        a1 = self.newest_auction(off + 2 * self.cap - 1)
        k, n = a1 + 1, 0
        while n < self.n_del and k < a1 + 1 + 8 * self.keys:
            key = k % self.keys
            k += 8
            if key in self.table and key not in change:
                out.append(f"DELETE FROM side_input VALUES ({key}, "
                           f"'{self.table.pop(key)}')")
                change[key] = None
                n += 1
        self.log.append((off + self.cap, change))
        return out


def _bid_reader(eng):
    return eng.jobs[0].sources["b"]


def k22_cases(torch, device, scale: int):
    """K22a's inputs: ``(name, executor, state, keys, key nulls, valid)``
    on ``device``, the build tables filled through the executor's right
    side (K3 and K8 on the card).

    - ``q13``: 8192 bids, key ``auction % 10000``, into the 2^14 table
      holding 10,000 keys and their texts;
    - ``int64``: 600 keys (100 deleted: tombstones) in 2^10 slots, with
      an int64, a nullable VARCHAR(8), an int32 and a float64 value;
      probes live, deleted, absent and NULL keys, a tenth of the rows
      invalid;
    - ``varchar8``: VARCHAR(8) keys as in ``tests/slt/temporal_join.slt``,
      some probe rows with nonzero bytes past their length;
    - ``two_col``: an (int64, VARCHAR(8)) primary key;
    - ``overflow``: 2^10 slots holding 1000 keys and 24 tombstones, no
      empty slot: every probe of an absent key walks the bound.
    Each as an inner and a left outer join."""
    import numpy as np

    from risingwave_tpu_torch.common.chunk import Chunk, split_col
    from risingwave_tpu_torch.common.types import DataType, Field, Schema
    from risingwave_tpu_torch.connector.nexmark import (
        NexmarkConfig,
        NexmarkGenerator,
    )
    from risingwave_tpu_torch.expr.node import InputRef
    from risingwave_tpu_torch.stream.temporal_join import (
        TemporalJoinExecutor,
    )

    rng = np.random.default_rng(22)
    cap = 8192 // scale

    def field(name, t, nullable=False, width=8):
        kw = {"str_width": width} if t == "VARCHAR" else {}
        return Field(name, getattr(DataType, t), nullable=nullable, **kw)

    def build(key_fields, value_fields, rows, deletes, size, join):
        right = Schema(tuple(key_fields + value_fields))
        left = Schema((field("id", "INT64"),) + tuple(
            f.with_nullable() for f in key_fields))
        ex = TemporalJoinExecutor(
            left, right, [InputRef(1 + i) for i in range(len(key_fields))],
            list(range(len(key_fields))), table_size=size, join_type=join)
        st = ex.init_state(device)
        for ops, batch in ((0, rows), (1, deletes)):
            for lo in range(0, len(batch), cap):
                part = batch[lo:lo + cap]
                arrays = [np.array([r[i] for r in part], object)
                          for i in range(len(right))]
                c = Chunk.from_numpy(right, arrays,
                                     ops=np.full(len(part), ops, np.int8),
                                     capacity=cap, device=device)
                st, _ = ex.apply(st, c, "right")
        return ex, left, st

    def probe(ex, left, st, rows, invalid=0.0, garbage=False):
        arrays = [np.array([r[i] for r in rows], object)
                  for i in range(len(left))]
        c = Chunk.from_numpy(left, arrays, capacity=cap, device=device)
        keys, nulls = [], []
        for k in ex.left_keys:
            d, n = split_col(k.eval(c))
            keys.append(d)
            nulls.append(n)
        if garbage:
            for d in keys:
                if hasattr(d, "lens"):
                    tail = torch.arange(d.data.shape[1], device=device) \
                        >= d.lens[:, None]
                    noisy = torch.from_numpy(rng.random(cap) < 0.2).to(device)
                    d.data.masked_fill_(tail & noisy[:, None], 0x5A)
        valid = c.valid & torch.from_numpy(
            rng.random(cap) >= invalid).to(device)
        return st, keys, nulls, valid

    cases = []
    for join in ("inner", "left_outer"):
        # q13's main-path shape
        n_keys = _q13_keys(scale)
        ex, left, st = build(
            [field("key", "INT64")], [field("value", "VARCHAR",
                                            width=STR_WIDTH)],
            [(k, str(k)) for k in range(n_keys)], [], (1 << 14) // scale,
            join)
        bids = NexmarkGenerator(NexmarkConfig(inter_event_us=1),
                                device).gen_bids(0, cap)
        cases.append((f"q13 {join}", ex, st, [bids.columns[0] % n_keys],
                      [None], bids.valid))

        values = [field("v", "INT64"), field("s", "VARCHAR", True),
                  field("w", "INT32"), field("f", "FLOAT64")]

        def vals():
            return (int(rng.integers(-10**9, 10**9)),
                    None if rng.random() < 0.3 else
                    "s" * int(rng.integers(0, 9)),
                    int(rng.integers(-99, 99)), float(rng.normal()))

        for name, key_fields, keyf, n, dead, size in (
                ("int64", [field("k", "INT64")],
                 lambda i: (i * 7 - 50,), 600, 100, 1 << 10),
                ("varchar8", [field("k", "VARCHAR")],
                 lambda i: (f"C{i:04d}"[: 5 + i % 4],), 600, 100, 1 << 10),
                ("two_col", [field("k", "INT64"), field("k2", "VARCHAR")],
                 lambda i: (i % 37, f"n{i // 37}"), 600, 100, 1 << 10),
                ("overflow", [field("k", "INT64")],
                 lambda i: (i,), 1024, 24, 1 << 10)):
            rows = [keyf(i) + vals() for i in range(n)]
            gone = [rows[int(i)] for i in rng.choice(n, dead, replace=False)]
            ex, left, st = build(key_fields, values, rows, gone, size, join)
            dead_keys = [r[:len(key_fields)] for r in gone]
            probes = []
            for _ in range(cap):
                u = rng.random()
                if name == "overflow":
                    key = keyf(n + int(rng.integers(0, 5000))) if u < 0.7 \
                        else rows[int(rng.integers(0, n))][:1]
                elif u < 0.45:
                    key = rows[int(rng.integers(0, n))][:len(key_fields)]
                elif u < 0.6:
                    key = dead_keys[int(rng.integers(0, dead))]
                elif u < 0.85:
                    key = keyf(n + int(rng.integers(0, 5000)))
                else:
                    key = tuple(None for _ in key_fields)
                probes.append((int(rng.integers(0, 1 << 40)),) + key)
            cases.append((f"{name} {join}", ex) + probe(
                ex, left, st, probes, invalid=0.1,
                garbage=name == "varchar8"))
    return cases


def _walk_steps(torch, table, keys, live) -> int:
    """Slots the lookups of ``keys`` visit (the active elements of K22a's
    walk), counted with the plain probe's rounds."""
    from risingwave_tpu_torch.common.hash import hash64_columns_plain
    from risingwave_tpu_torch.state.hash_table import gather_key, keys_equal

    size = table.size
    start = (hash64_columns_plain(keys) & (size - 1)).to(torch.int64)
    done = ~live
    steps = 0
    for off in range(min(size + 2, 1024)):
        pending = ~done
        n = int(pending.sum())
        if n == 0:
            break
        steps += n
        cand = (start + off) & (size - 1)
        occ = table.occupied[cand]
        match = occ.clone()
        for s, k in zip(table.key_cols, keys):
            match &= keys_equal(gather_key(s, cand), k)
        done = done | (pending & (match | (~occ & ~table.tombstone[cand])))
    return steps


def phase_temporal_kernels(torch, device, timer, scale):
    """K22a against its plain version on the card, exactly (every output
    leaf, the valid plane and the overflow count) on ``k22_cases``; timed
    on q13's main-path shape with the bound of the bytes its rows need."""
    from risingwave_tpu_torch.common.chunk import StrCol, split_col
    from risingwave_tpu_torch.common.hash import hash64_columns
    from risingwave_tpu_torch.common.tree import flatten
    from risingwave_tpu_torch.stream.temporal_join import (
        temporal_probe,
        temporal_probe_plain,
    )

    pairs = []
    overflows = {}
    q13 = None
    for name, ex, st, keys, nulls, valid in k22_cases(torch, device, scale):
        left = ex.join_type == "left_outer"
        outs = []
        for fn in (temporal_probe, temporal_probe_plain):
            over = torch.zeros((), dtype=torch.int64, device=device)
            cols, v = fn(st.right.table, st.right.values, keys, nulls, valid,
                         over, left)
            outs.append((flatten(tuple(cols))[0], v, over))
        (ka, va, oa), (kb, vb, ob) = outs
        pairs += [(f"{name} leaf {i}", a, b)
                  for i, (a, b) in enumerate(zip(ka, kb))]
        pairs += [(f"{name} valid", va, vb), (f"{name} overflow", oa, ob)]
        overflows[name] = int(oa)
        if name == "q13 inner":
            q13 = (st, keys, nulls, valid)
    err = max_abs_err(torch, pairs)
    if not (overflows["overflow inner"] > 0
            and overflows["overflow left_outer"] > 0):
        fail(f"K22a: the full table drove no probe-bound overflow "
             f"({overflows})")
    if any(v for k, v in overflows.items() if not k.startswith("overflow")):
        fail(f"K22a: overflow where the table has empty slots ({overflows})")
    st, keys, nulls, valid = q13
    table, values = st.right.table, st.right.values
    start = (hash64_columns(keys) & (table.size - 1)).to(torch.int32)
    over = torch.zeros((), dtype=torch.int64, device=device)
    if device.type == "cuda":
        from risingwave_tpu_torch.stream.temporal_join import (
            temporal_probe_cuda,
        )
        ms = timer(lambda i: temporal_probe_cuda(
            table, values, keys, nulls, valid, over, False, start), 200)
    else:
        ms = timer(lambda i: temporal_probe_plain(
            table, values, keys, nulls, valid, over, False), 2)
    plain_ms = timer(lambda i: temporal_probe_plain(
        table, values, keys, nulls, valid, over, False), 20)
    cap = valid.shape[0]
    steps = _walk_steps(torch, table, keys, valid)
    row = sum(x.element_size() * x[0].numel()
              for x in flatten(tuple(values))[0])
    key = sum(x.element_size() * x[0].numel()
              for x in flatten(tuple(keys))[0])
    # the build row's active elements at a found slot: its fixed-width
    # leaves and null planes, and a string's bytes up to its length
    cols, hit = temporal_probe_plain(
        table, values, keys, nulls, valid,
        torch.zeros((), dtype=torch.int64, device=device), False)
    found = int(hit.sum())
    fixed, str_bytes = 0, 0
    for store, col in zip(values, cols):
        data, null = split_col(store)
        fixed += 0 if null is None else 1
        if isinstance(data, StrCol):
            fixed += data.lens.element_size()
            str_bytes += int(split_col(col)[0].lens[hit].sum())
        else:
            fixed += data.element_size()
    # per row: valid read, the output row written whole (zeros past a
    # string's length included) and its valid; per valid row: the key
    # and first slot; per found row: the build row's active elements;
    # per visited slot: occupied, tombstone and the stored key
    nbytes = (cap * (1 + row + 1) + int(valid.sum()) * (key + 4)
              + found * fixed + str_bytes + steps * (2 + key))
    b_ = bound(nbytes, steps * 10 + cap * 8)
    print(f"[temporal_probe] exact on {len(pairs)} leaves over q13's shape "
          f"(8192 bids, auction % 10000, 10,000 keys in 2^14 slots; "
          f"{steps} slots visited, {found} found, {str_bytes} string "
          f"bytes read), int64/VARCHAR(8)/two-column keys with "
          f"NULL keys, misses, tombstones and bytes past lengths, inner and "
          f"left outer pads, and a full table (overflow "
          f"{overflows['overflow inner']} = plain); kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {b_[0]:.6f} ms", flush=True)
    return {"temporal_probe": kernel_entry(
        "temporal_probe.cu", "risingwave_tpu/stream/temporal_join.py:80",
        ms, plain_ms, b_, None, err)}


def _q13_engine(torch, device, scale, left: bool, data_dir=None,
                sources: str = BENCH_SOURCES, cfg=None):
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig

    eng = Engine(PlannerConfig(**(cfg or _q13_config(scale))),
                 data_dir=data_dir, device=device)
    for sql in _q13_ddl(scale, left, sources):
        eng.execute(sql)
    return eng


def _q13_tick(eng, churn, t: int, per: int) -> None:
    """One barrier of ``per`` rounds, after barrier ``t``'s DML."""
    if churn is not None:
        for sql in churn.sql(t, _bid_reader(eng).offset):
            eng.execute(sql)
    eng.tick(barriers=1, chunks_per_barrier=per)


def phase_q13_parity(torch, device, left: bool) -> None:
    """q13 (inner) and its LEFT JOIN variant with churn at 1M events/s,
    chunk 256, 500 keys, on the card and on the CPU: the ring, the build
    table's ``MvState`` and every counter must be equal."""
    from risingwave_tpu_torch.compat import state_mismatches, state_to_numpy

    scale = 20
    cfg = dict(chunk_capacity=256, mv_ring_size=1 << 14,
               join_table_size=1 << 10)
    engines, churns = [], []
    for dev in (device, torch.device("cpu")):
        engines.append(_q13_engine(torch, dev, scale, left, cfg=cfg))
        churns.append(Q13Churn(_q13_keys(scale), 256, scale) if left
                      else None)
    for t in range(6):
        for eng, churn in zip(engines, churns):
            _q13_tick(eng, churn, t, 4)
    rows = [e.execute("SELECT * FROM nexmark_q13") for e in engines]
    if rows[0] != rows[1] or not rows[0]:
        fail(f"q13 {'LEFT ' if left else ''}ring on the card differs from "
             "the CPU plain versions")
    bad = state_mismatches(state_to_numpy(engines[1].jobs[0].states),
                           engines[0].jobs[0].states)
    if bad:
        fail(f"q13 state on the card differs from the CPU: {bad[:5]}")
    pads = sum(r[4] is None for r in rows[0])
    print(f"[parity] q13{' LEFT JOIN with churn' if left else ''}, 6 "
          f"barriers: {len(rows[0])} ring rows ({pads} pads) and all state "
          f"(the build MvState, TjState's counters) equal to the CPU plain "
          f"versions", flush=True)


def check_q13(eng, cap: int, keys: int, churn) -> str:
    """The ring against numpy over the consumed bids: auction, bidder,
    price and date_time as consumed, and the value the build table held
    when the bid was probed: the text of ``auction % keys`` (q13), or the
    host model of the churn, DML rows applying from the bid ordinal where
    the DAG consumed them (a deleted key's row a NULL pad)."""
    import numpy as np

    from risingwave_tpu_torch.common.chunk import encode_strings
    from risingwave_tpu_torch.common.tree import flatten

    reader = _bid_reader(eng)
    cols = {k: [] for k in ("auction", "bidder", "price", "ts")}
    for i in range(reader.offset // cap):
        c = reader.gen.gen_bids(i * cap, cap).columns
        for k, x in zip(cols, (c[0], c[1], c[2], c[5])):
            cols[k].append(x.cpu().numpy())
    b = {k: np.concatenate(v) for k, v in cols.items()}
    entry = eng.catalog.get("nexmark_q13")
    node, idx = entry.mv_state_index
    ring = eng.jobs[0].states[node][idx]
    n = int(ring.cursor)
    leaves = [x[:n].cpu().numpy() for x in flatten(ring.values)[0]]
    total = b["price"].shape[0]
    if n != total or int(ring.overflow):
        fail(f"q13 ring holds {n} rows (overflow {int(ring.overflow)}) for "
             f"{total} bids")
    data, lens = encode_strings([str(k) for k in range(keys)], STR_WIDTH)
    null = np.zeros(keys, bool)
    want_d = np.zeros((total, STR_WIDTH), np.uint8)
    want_l = np.zeros(total, np.int32)
    want_n = np.zeros(total, bool)
    key = b["auction"] % keys
    log = churn.log if churn is not None else []
    bounds = [0] + [min(o, total) for o, _ in log] + [total]
    for seg, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
        want_d[lo:hi] = data[key[lo:hi]]
        want_l[lo:hi] = lens[key[lo:hi]]
        want_n[lo:hi] = null[key[lo:hi]]
        if seg < len(log):
            for k, v in log[seg][1].items():
                null[k] = v is None
                d, ln = encode_strings([v or ""], STR_WIDTH)
                data[k], lens[k] = (0, 0) if v is None else (d[0], ln[0])
    want = [b["auction"], b["bidder"], b["price"], b["ts"]]
    if churn is None:
        want += [want_d, want_l]
    else:
        live = ~want_n
        leaves[4], leaves[5] = leaves[4][live], leaves[5][live]
        want += [want_d[live], want_l[live], want_n]
    if len(want) != len(leaves):
        fail(f"q13 ring has {len(leaves)} leaves, expected {len(want)}")
    for i, (got, exp) in enumerate(zip(leaves, want)):
        if got.shape != exp.shape or not np.array_equal(got, exp):
            fail(f"q13 ring leaf {i} differs from numpy")
    pads = int(want_n.sum())
    seen = int(sum((want_d[:, 0] == ord("u")) & ~want_n))
    return (f"ring rows equal numpy over {n} bids, {len(leaves)} leaves, no "
            f"lap" + (f"; {seen} rows carry an UPDATEd value and {pads} are "
                      f"NULL pads of DELETEd keys" if churn else ""))


def phase_q13_main_path(torch, device, scale, churn_path: bool):
    """q13 at bench.py's sizes (``churn_path``: the LEFT JOIN over a
    retractable table with ``Q13Churn``'s DML before each timed barrier,
    and the same run on the CPU compared tensor for tensor): 9 warm-up
    and 32 timed barriers of 8 rounds, the launch counters over the timed
    window, rows/s of bid rows, one profiled window, the counter audit
    and the ring against numpy."""
    import gc

    from risingwave_tpu_torch import kernels

    cuda = device.type == "cuda"
    tag = "q13 churn" if churn_path else "q13"
    barriers = BARRIERS if cuda else 2
    warm = WARMUP_BARRIERS if cuda else 1
    cap = _q13_config(scale)["chunk_capacity"]
    eng = _q13_engine(torch, device, scale, left=churn_path)
    churn = Q13Churn(_q13_keys(scale), cap, scale) if churn_path else None
    eng.tick(barriers=warm, chunks_per_barrier=CHUNKS_PER_BARRIER)
    if cuda:
        torch.cuda.synchronize()
    kernels.reset_launches()
    off0 = _bid_reader(eng).offset
    t0 = time.perf_counter()
    for t in range(barriers):
        _q13_tick(eng, churn, t, CHUNKS_PER_BARRIER)
    if cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    chunks = barriers * CHUNKS_PER_BARRIER
    bid_rows = _bid_reader(eng).offset - off0
    rate = bid_rows / dt
    print(f"[main] {tag} {bid_rows} bid rows in {dt:.3f} s = {rate:.0f} "
          f"rows/s (the table reader's idle rounds skipped and not counted"
          f"{', DML statements included' if churn else ''}); K22a launches "
          f"per chunk {launches['temporal_probe'] / chunks:.2f}; port kernel "
          f"launches {sum(launches.values()) / chunks:.2f} per chunk "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    if cuda:
        per_chunk = profile_window(torch, eng, tag)
        print(f"[main] {tag} launches per chunk "
              f"{'not measured' if per_chunk is None else f'{per_chunk:.1f}'}"
              f" (all CUDA kernels, profiled window)", flush=True)
    eng.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1")
    eng.tick(barriers=1, chunks_per_barrier=0)
    st = eng.jobs[0].states[1]
    if int(st.overflow) or int(st.right.overflow) or int(st.inconsistency):
        fail(f"{tag}: the temporal join's loss counters are not 0")
    print(f"[check] {tag} {check_q13(eng, cap, _q13_keys(scale), churn)}; "
          f"every loss counter 0", flush=True)
    if churn_path:
        _q13_against_cpu(torch, eng, scale, barriers, warm)
    del eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return launches, rate


def _q13_against_cpu(torch, eng, scale, barriers: int, warm: int) -> None:
    """The churn path once more on the CPU (plain versions), with the
    same DML at the same barriers (the card's profiled barriers
    included): the ring and every state tensor must be equal."""
    from risingwave_tpu_torch.compat import state_mismatches, state_to_numpy

    cap = _q13_config(scale)["chunk_capacity"]
    cpu = _q13_engine(torch, torch.device("cpu"), scale, left=True)
    churn = Q13Churn(_q13_keys(scale), cap, scale)
    cpu.tick(barriers=warm, chunks_per_barrier=CHUNKS_PER_BARRIER)
    for t in range(barriers):
        _q13_tick(cpu, churn, t, CHUNKS_PER_BARRIER)
    extra = (_bid_reader(eng).offset - _bid_reader(cpu).offset) \
        // (cap * CHUNKS_PER_BARRIER)
    cpu.tick(barriers=extra, chunks_per_barrier=CHUNKS_PER_BARRIER)
    cpu.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1")
    cpu.tick(barriers=1, chunks_per_barrier=0)
    bad = state_mismatches(state_to_numpy(cpu.jobs[0].states),
                           eng.jobs[0].states)
    if bad or _bid_reader(cpu).offset != _bid_reader(eng).offset:
        fail(f"q13 churn on the card differs from the CPU: {bad[:5]}")
    print(f"[check] q13 churn: the ring, the build table and every counter "
          f"equal the port on the CPU over the same {barriers + warm + extra}"
          f" barriers and DML", flush=True)


def phase_q13_durable(torch, device, scale, storeless_rate):
    """q13 churn durably (``Engine(config, data_dir=...)``): 9 warm-up
    and 32 timed barriers with churn and a snapshot every 8 checkpoints,
    then a cold start from the directory (the DDL log and the DML
    journal: 10,000 rows plus the churn, the last barrier's unconsumed),
    8 more barriers with churn, and every state tensor against an engine
    that ran the same barriers and DML without stopping."""
    import gc
    import shutil
    import tempfile

    from risingwave_tpu_torch import kernels
    from risingwave_tpu_torch.common.tree import flatten
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig

    cuda = device.type == "cuda"
    timed = BARRIERS if cuda else BARRIERS // 4
    per = CHUNKS_PER_BARRIER if cuda else CHUNKS_PER_BARRIER // 4
    cap = _q13_config(scale)["chunk_capacity"]
    data_dir = tempfile.mkdtemp(prefix="rw_durable_q13_")
    try:
        eng = _q13_engine(torch, device, scale, True, data_dir)
        churn = Q13Churn(_q13_keys(scale), cap, scale)
        eng.tick(barriers=WARMUP_BARRIERS, chunks_per_barrier=per)
        job = eng.jobs[0]
        if cuda:
            torch.cuda.synchronize()
        kernels.reset_launches()
        off0 = _bid_reader(eng).offset
        t0 = time.perf_counter()
        for t in range(timed):
            _q13_tick(eng, churn, t, per)
        if cuda:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        rate = (_bid_reader(eng).offset - off0) / dt
        sealed = (WARMUP_BARRIERS + timed) // 8 * 8
        if job.committed_epoch != job.sealed_epoch:
            fail("q13 durable: the uploads did not drain")
        journal = len(eng.meta_store.dml_rows("side_input"))
        print(f"[durable] q13 churn {rate:.0f} rows/s (store-less run of "
              f"this process: {storeless_rate:.0f} rows/s); DML journal "
              f"{journal} rows", flush=True)
        del eng, job
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # -- the cold start --------------------------------------------
        t0 = time.perf_counter()
        cold = Engine(PlannerConfig(**_q13_config(scale)), data_dir=data_dir,
                      device=device)
        if cuda:
            torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
        history = cold.catalog.get("side_input").dml
        if len(history.history_slice(0)) != journal:
            fail("q13 cold start: the table's history was not reloaded")
        # the stopped engine's last barrier is replayed: its DML is in
        # the journal and its rows unconsumed at the committed epoch
        tail = WARMUP_BARRIERS + timed - sealed
        for t in range(timed, timed + 8):
            _q13_tick(cold, churn, t, per)
        whole = _q13_engine(torch, device, scale, True)
        model = Q13Churn(_q13_keys(scale), cap, scale)
        whole.tick(barriers=WARMUP_BARRIERS, chunks_per_barrier=per)
        t = 0
        while t < timed + 8:
            if t == timed - tail:
                # the lost barriers' DML and the first replayed one's
                # land before one barrier, as in the cold engine
                for u in range(t, timed + 1):
                    for sql in model.sql(u, _bid_reader(whole).offset):
                        whole.execute(sql)
                whole.tick(barriers=1, chunks_per_barrier=per)
                t = timed + 1
                continue
            _q13_tick(whole, model, t, per)
            t += 1
        la = flatten(cold.jobs[0].states)[0]
        lb = flatten(whole.jobs[0].states)[0]
        max_abs_err(torch, [(f"q13 cold start leaf {i}", a, b)
                            for i, (a, b) in enumerate(zip(la, lb))])
        if sorted(cold.execute("SELECT * FROM nexmark_q13"), key=repr) != \
                sorted(whole.execute("SELECT * FROM nexmark_q13"), key=repr):
            fail("q13: MV rows differ after the cold start")
        print(f"[cold start] q13 churn recovered the epoch of barrier "
              f"{sealed} in {rec_s:.3f} s (DDL replay, the DML journal's "
              f"{journal} rows reloaded, load, upload to the device); after "
              f"8 more barriers with churn every state tensor (the ring in "
              f"order, the build table) equals an engine that ran "
              f"{sealed + 8} barriers and the same DML without stopping",
              flush=True)
        del cold, whole
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        return launches, rate, {"recover_s": rec_s}
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# slice 10: scalar functions, casts, avg and SQL UDFs (K23e-h)


#: Nexmark q14 (nexmark-flink's q14.sql: the projection, CASE and filter
#: as published) over this repo's bid schema, which has no ``extra``
#: column: the UDF counts the ``'e'``s of ``url`` (no generated url has a
#: ``'c'``; every one has three ``'e'``s)
Q14_SQL = """
CREATE FUNCTION count_char(s varchar, c varchar) RETURNS int
LANGUAGE SQL AS $$SELECT LENGTH(s) - LENGTH(REPLACE(s, c, ''))$$;

CREATE MATERIALIZED VIEW nexmark_q14 AS
SELECT
    auction,
    bidder,
    0.908 * price as price,
    CASE
        WHEN
            extract(hour from date_time) >= 8 AND
            extract(hour from date_time) <= 18
        THEN 'dayTime'
        WHEN
            extract(hour from date_time) <= 6 OR
            extract(hour from date_time) >= 20
        THEN 'nightTime'
        ELSE 'otherTime'
    END AS bidTimeType,
    date_time,
    url,
    count_char(url, 'e') AS c_counts
FROM bid
WHERE 0.908 * price > 1000000 AND 0.908 * price < 50000000;
"""
SCALAR_QUERY_SQL = {
    "q14": Q14_SQL,
    # the LIKE family, substr, trim, ||, the calendar's date parts, CAST
    # and the NUMERIC and float divides
    "bid_strings": """
CREATE MATERIALIZED VIEW bid_strings AS
SELECT auction, substr(channel, 1, 3) AS pre, channel || url AS cu,
       trim(' ' || channel || ' ') AS ch, ltrim(url) AS lu,
       extract(year from date_time) AS y, extract(doy from date_time) AS d,
       CAST(price AS DOUBLE PRECISION) / 3 AS p3, price / 7.0 AS p7
FROM bid
WHERE url LIKE 'https://%page1%item'
  AND (starts_with(channel, 'G') OR contains(url, 'page2') OR channel LIKE '%u');
""",
    # avg over BIGINT (float64 out) and over NUMERIC (truncating)
    "avg_bid": """
CREATE MATERIALIZED VIEW avg_bid AS
SELECT auction, avg(price) AS avg_price, avg(0.908 * price) AS avg_price_eur,
       count(*) AS bids
FROM bid GROUP BY auction;
""",
}
SCALAR_QUERIES = tuple(SCALAR_QUERY_SQL)
SCALAR_MV = {"q14": "nexmark_q14", "bid_strings": "bid_strings",
             "avg_bid": "avg_bid"}
#: the K23e-h kernels' names in ``kernels.KERNELS``
K23_REST_KERNELS = ("str_replace", "str_match", "str_window", "calendar")


def phase_scalar_kernels(torch, device, timer, scale):
    """K23e-h against their plain versions on the card, exactly, and
    against Python: on 8192 rows of ``k23_rest_cases`` (replace's greedy
    overlaps and its clamp, the match functions and every LIKE of
    ``K23F_LIKE``, substr's PostgreSQL windows, the trims around spaces,
    concat, every extract part over 1600-2400 and over dates) and at the
    main paths' shapes (a bid chunk: url 40 B, channel 16 B, 64 B
    stride-0 literals, date_time), which also time each kernel, its plain
    version and the bound of the bytes its rows need."""
    import datetime as dt

    import numpy as np

    from risingwave_tpu_torch.connector.nexmark import NexmarkGenerator
    from risingwave_tpu_torch.expr import strings as S
    from risingwave_tpu_torch.expr.scalar import LikePattern

    cap = 8192 // scale
    cs = k23_rest_cases(cap)
    col = {k: _strcol(torch, device, cs[k])
           for k in ("strs", "other", "frm", "to", "pats", "spaced")}
    start = torch.from_numpy(cs["start"]).to(device)
    count = torch.from_numpy(cs["count"]).to(device)
    ts = torch.from_numpy(cs["ts"]).to(device)
    days = torch.from_numpy(cs["days"]).to(device)
    bids = NexmarkGenerator(device=device).gen_bids(0, cap)
    channel, url, date_time = bids.columns[3], bids.columns[4], \
        bids.columns[5]
    lit = {v: _literal_col(torch, device, v, cap)
           for v in (b"e", b"", b"x", b"yy", b"aa", b"b", b"Q", b"G",
                     b"page2", b" ", b"channel=ab")}
    ul = int(url.lens.sum())
    out = {}

    def texts(c):
        d = c.data.contiguous().cpu().numpy()
        ln = c.lens.contiguous().cpu().numpy()
        return [bytes(d[i, :ln[i]]) for i in range(d.shape[0])]

    def oracle(tag, got, want):
        got = texts(got) if not isinstance(got, list) else got
        for i, (g, w) in enumerate(zip(got, want)):
            if g != w:
                fail(f"{tag} row {i}: {g!r} vs Python {w!r}")

    rows = {k: texts(col[k]) for k in ("strs", "other", "frm", "to",
                                       "pats", "spaced")}

    # -- K23e str_replace -------------------------------------------------
    runs = [("columns", col["strs"], col["frm"], col["to"]),
            ("'e' to ''", col["strs"], lit[b"e"], lit[b""]),
            ("'x' to 'yy' (clamped)", col["strs"], lit[b"x"], lit[b"yy"]),
            ("'aa' to 'b'", col["strs"], lit[b"aa"], lit[b"b"]),
            ("empty from", col["strs"], lit[b""], lit[b"Q"]),
            ("q14 url 'e' to ''", url, lit[b"e"], lit[b""])]
    pairs = []
    for tag, a, f, t in runs:
        pairs += _str_pairs(f"replace {tag}", (S.str_replace(a, f, t),),
                            (S.str_replace_plain(a, f, t),))
    err = max_abs_err(torch, pairs)
    oracle("replace", S.str_replace(col["strs"], col["frm"], col["to"]),
           [(s.replace(f, t) if f else s)[:40] for s, f, t in
            zip(rows["strs"], rows["frm"], rows["to"])])
    ms = timer(lambda i: S.str_replace(url, lit[b"e"], lit[b""]), 200)
    plain_ms = timer(lambda i: S.str_replace_plain(url, lit[b"e"],
                                                   lit[b""]), 10,
                     prefill_ms=20.0)
    # per row: its active url bytes, length and the two literals' rows
    # read; the output row and its length written; ~4 operations a byte
    b_ = bound(ul + cap * 4 + 2 * 68 + cap * (url.data.shape[1] + 4),
               ul * 4)
    print(f"[str_replace] exact on {cap} edge-case rows (per-row and "
          f"literal patterns, greedy overlaps, empty from, a to longer than "
          f"from clamped at the width) and q14's replace(url, 'e', ''), "
          f"equal to Python's bytes.replace; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b_[0]:.5f} ms", flush=True)
    out["str_replace"] = kernel_entry(
        "str_replace.cu", "risingwave_tpu/expr/scalar.py:771", ms, plain_ms,
        b_, None, err)

    # -- K23f str_match and LIKE -------------------------------------------
    pairs = []
    for mode in S.MATCH_MODES:
        for tag, a, p in (("columns", col["strs"], col["pats"]),
                          ("literal", col["strs"], lit[b"aa"]),
                          ("literal left", lit[b"channel=ab"], col["pats"]),
                          ("empty", col["strs"], lit[b""]),
                          ("channel 'G'", channel, lit[b"G"]),
                          ("url 'page2'", url, lit[b"page2"])):
            pairs.append((f"{mode} {tag}", S.str_match(a, p, mode),
                          S.str_match_plain(a, p, mode)))
        got = S.str_match(col["strs"], col["pats"], mode).cpu().numpy()
        py = {"starts_with": bytes.startswith, "ends_with": bytes.endswith,
              "contains": lambda s, p: p in s}[mode]
        oracle(mode, [bool(x) for x in got],
               [py(s, p) for s, p in zip(rows["strs"], rows["pats"])])
    for pat in K23F_LIKE:
        node = LikePattern(None, pat)
        args = (node.segs, node.anchor_start, node.anchor_end)
        for tag, a in (("edge cases", col["strs"]),
                       ("spaced", col["spaced"]), ("url", url),
                       ("channel", channel)):
            pairs.append((f"like {pat!r} {tag}", S.like_match(a, *args),
                          S.like_match_plain(a, *args)))
        got = S.like_match(col["strs"], *args).cpu().numpy()
        oracle(f"like {pat!r}", [bool(x) for x in got],
               [k23_python_like(s, pat) for s in rows["strs"]])
    err = max_abs_err(torch, pairs)
    node = LikePattern(None, "https://%page1%item")
    args = (node.segs, node.anchor_start, node.anchor_end)
    ms = timer(lambda i: S.like_match(url, *args), 200)
    plain_ms = timer(lambda i: S.like_match_plain(url, *args), 10,
                     prefill_ms=20.0)
    n_true = int(S.like_match(url, *args).sum())
    # per row: its active url bytes (the walk reads up to the decision,
    # at most the string) and length read, 1 B written
    b_ = bound(ul + cap * 5 + 64, ul * 4)
    print(f"[str_match] exact on {cap} edge-case rows (starts_with, "
          f"ends_with, contains over per-row and literal patterns, longer "
          f"and empty ones; {len(K23F_LIKE)} LIKE patterns over edge cases, "
          f"spaced strings, url and channel), equal to Python and "
          f"re.fullmatch; bid_strings' url LIKE 'https://%page1%item' "
          f"({n_true} of {cap}): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, bound {b_[0]:.5f} ms", flush=True)
    out["str_match"] = kernel_entry(
        "str_match.cu", "risingwave_tpu/expr/scalar.py:943", ms, plain_ms,
        b_, None, err)

    # -- K23g str_window: substr, trims, concat ----------------------------
    one = torch.ones(cap, dtype=torch.int32, device=device)
    three = torch.full((cap,), 3, dtype=torch.int32, device=device)
    pairs = []
    for tag, a in (("edge cases", col["strs"]), ("spaced", col["spaced"]),
                   ("channel", channel)):
        pairs += _str_pairs(f"substr3 {tag}",
                            (S.str_substr(a, start, count),),
                            (S.str_substr_plain(a, start, count),))
        pairs += _str_pairs(f"substr2 {tag}", (S.str_substr(a, start),),
                            (S.str_substr_plain(a, start),))
        pairs += _str_pairs(f"substr(1, 3) {tag}",
                            (S.str_substr(a, one, three),),
                            (S.str_substr_plain(a, one, three),))
        for m in ("trim", "ltrim", "rtrim"):
            pairs += _str_pairs(f"{m} {tag}", (S.str_trim(a, m),),
                                (S.str_trim_plain(a, m),))
        pairs += _str_pairs(f"concat {tag}", (S.str_concat(a, url),),
                            (S.str_concat_plain(a, url),))
        pairs += _str_pairs(f"concat literal {tag}",
                            (S.str_concat(lit[b" "], a),),
                            (S.str_concat_plain(lit[b" "], a),))
    err = max_abs_err(torch, pairs)
    got = S.str_substr(col["strs"], start, count)
    want = []
    for s, st, c in zip(rows["strs"], cs["start"], cs["count"]):
        lo, hi = max(int(st) - 1, 0), min(int(st) - 1 + max(int(c), 0),
                                          len(s))
        want.append(s[lo:hi] if hi > lo else b"")
    oracle("substr", got, want)
    for m, py in (("trim", bytes.strip), ("ltrim", bytes.lstrip),
                  ("rtrim", bytes.rstrip)):
        oracle(m, S.str_trim(col["spaced"], m),
               [py(s, b" ") for s in rows["spaced"]])
    oracle("concat", S.str_concat(col["strs"], col["other"]),
           [a + b for a, b in zip(rows["strs"], rows["other"])])
    ms = timer(lambda i: S.str_concat(channel, url), 200)
    plain_ms = timer(lambda i: S.str_concat_plain(channel, url), 20,
                     prefill_ms=3.0)
    sub_ms = timer(lambda i: S.str_substr(channel, one, three), 200)
    trim_ms = timer(lambda i: S.str_trim(url, "ltrim"), 200)
    cl = int(channel.lens.sum())
    wo = channel.data.shape[1] + url.data.shape[1]
    # channel || url: both rows' active bytes and lengths read, the
    # output row and length written; a few operations a byte
    b_ = bound(cl + ul + cap * 8 + cap * (wo + 4), (cl + ul) * 2)
    print(f"[str_window] exact on {cap} edge-case rows (substr with "
          f"per-row, non-positive starts and negative counts, with and "
          f"without a count, trim/ltrim/rtrim around spaces, concat with "
          f"columns and a literal), equal to Python's slicing, strip and "
          f"+; bid_strings' channel || url: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b_[0]:.5f} ms (substr(channel, 1, 3) "
          f"{sub_ms:.4f} ms, ltrim(url) {trim_ms:.4f} ms)", flush=True)
    out["str_window"] = kernel_entry(
        "str_window.cu", "risingwave_tpu/expr/scalar.py:509", ms, plain_ms,
        b_, None, err)
    out["str_window"]["at_shapes"] = {"substr_ms": sub_ms,
                                      "ltrim_ms": trim_ms}

    # -- K23h calendar -------------------------------------------------------
    pairs = []
    for part in S.EXTRACT_PARTS:
        for tag, x, date in (("timestamps", ts, False), ("dates", days, True),
                             ("date_time", date_time, False)):
            pairs.append((f"extract {part} {tag}", S.extract(x, part, date),
                          S.extract_plain(x, part, date)))
    err = max_abs_err(torch, pairs)
    epoch = dt.datetime(1970, 1, 1)
    got = {p: S.extract(ts, p).cpu().numpy() for p in S.EXTRACT_PARTS}
    for i, us in enumerate(cs["ts"].tolist()):
        if not -62_135_596_800_000_000 <= us < 253_402_300_800_000_000:
            continue
        t = epoch + dt.timedelta(microseconds=us)
        want = {"year": t.year, "month": t.month, "day": t.day,
                "hour": t.hour, "minute": t.minute, "second": t.second,
                "dow": t.isoweekday() % 7, "doy": t.timetuple().tm_yday,
                "epoch": us // 10**6}
        for p, w in want.items():
            if int(got[p][i]) != w:
                fail(f"extract {p} of {us}: {int(got[p][i])} vs datetime {w}")
    ms = timer(lambda i: S.extract(date_time, "hour"), 200)
    plain_ms = timer(lambda i: S.extract_plain(date_time, "hour", False), 20)
    b_ = bound(cap * 16, cap * 40)
    hours = np.unique(S.extract(date_time, "hour").cpu().numpy())
    print(f"[calendar] exact on {cap} timestamps from 1600 to 2400 (year "
          f"boundaries, leap days, the int64 extremes) and dates over "
          f"+-2^26 days, every part, equal to datetime; q14's "
          f"extract(hour from date_time) (hours {hours.tolist()}): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_[0]:.5f} ms",
          flush=True)
    out["calendar"] = kernel_entry(
        "calendar.cu", "risingwave_tpu/expr/scalar.py:659", ms, plain_ms,
        b_, None, err)
    return out


#: the card-against-CPU runs' sizes
SCALAR_PARITY_CONFIG = dict(chunk_capacity=256, agg_table_size=1 << 10,
                            agg_emit_capacity=64, mv_table_size=1 << 12,
                            mv_ring_size=1 << 14)


def _scalar_config(scale: int) -> dict:
    """bench.py's sizes with a ring of 2^23 (no lap)."""
    cfg = {k: v // scale for k, v in BENCH_CONFIG.items()}
    cfg["mv_ring_size"] = (1 << 23) // scale
    return cfg


def _scalar_ddl(query: str, rate: str) -> list[str]:
    return [BENCH_SOURCES.replace("'1000000'", f"'{rate}'"),
            SCALAR_QUERY_SQL[query]]


def phase_sql_parity(torch, device, query: str, ddl: list[str], cfg: dict,
                     mv: str, rate: str) -> None:
    """``ddl`` (sources at ``rate`` events/s and the view ``mv``) on the
    card and on the CPU (plain versions; the aggregation forced onto the
    card's pre-aggregation branch) at the small sizes ``cfg``, 6
    barriers: the MV's rows and every state tensor (the minput buckets
    and the EOWC table included) must be equal."""
    from risingwave_tpu_torch.compat import state_mismatches, state_to_numpy
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig
    from risingwave_tpu_torch.stream import hash_agg

    engines = []
    card_branch = hash_agg.accel_tuned
    for dev in (device, torch.device("cpu")):
        if dev.type == "cpu":
            hash_agg.accel_tuned = lambda d: True
        try:
            eng = Engine(PlannerConfig(**cfg), device=dev)
            for stmt in ddl:
                eng.execute(stmt)
            eng.tick(barriers=6, chunks_per_barrier=4)
        finally:
            hash_agg.accel_tuned = card_branch
        engines.append(eng)
    rows = [sorted((tuple(v if isinstance(v, str) else _host_value(v)
                          for v in r)
                    for r in e.execute(f"SELECT * FROM {mv}")), key=repr)
            for e in engines]
    if rows[0] != rows[1] or not rows[0]:
        fail(f"{query} MV on the card differs from the CPU plain versions")
    bad = state_mismatches(state_to_numpy(engines[1].jobs[0].states),
                           engines[0].jobs[0].states)
    if bad:
        fail(f"{query} state on the card differs from the CPU: {bad[:5]}")
    print(f"[parity] {query} at {rate} events/s, 6 barriers: {len(rows[0])} "
          f"MV rows and all state equal to the CPU plain versions",
          flush=True)


def _price_eur(price):
    """0.908 * price at the engine scale, as the port's NUMERIC multiply
    computes it: round(908000 * (price * 10^6) / 10^6), half to even."""
    import numpy as np

    return np.round(np.float64(908_000) * (price * 10**6).astype(np.float64)
                    / 1e6).astype(np.int64)


def _ring_check(query: str, n: int, overflow: int, leaves, want, what: str):
    import numpy as np

    total = want[0].shape[0]
    if n != total or overflow:
        fail(f"{query} ring holds {n} rows (overflow {overflow}) for {total} "
             "expected")
    if len(want) != len(leaves):
        fail(f"{query} ring has {len(leaves)} leaves, expected {len(want)}")
    for i, (got, exp) in enumerate(zip(leaves, want)):
        if got.shape != exp.shape or got.dtype != exp.dtype \
                or not np.array_equal(got, exp):
            fail(f"{query} ring leaf {i} differs from numpy/Python")
    return f"ring rows equal numpy/Python ({what}) over {n} rows, no lap"


def check_q14(eng, cap: int) -> str:
    """The ring against numpy and Python over the consumed bids: the
    filter on 0.908 * price (NUMERIC), the CASE over the hour (datetime),
    the url and count_char = url.count(b'e'), leaf for leaf."""
    import datetime as dt

    import numpy as np

    b = _consumed_bid_rows(eng, cap)
    n, overflow, leaves = _ring_planes(eng, "nexmark_q14")
    eur = _price_eur(b["price"])
    keep = (eur > 10**12) & (eur < 5 * 10**13)
    hour_keys = b["ts"][keep] // 3_600_000_000

    def kind(h):
        t = dt.datetime(1970, 1, 1) + dt.timedelta(hours=int(h))
        hr = t.hour
        if 8 <= hr <= 18:
            return b"dayTime"
        return b"nightTime" if hr <= 6 or hr >= 20 else b"otherTime"

    kd, kl = _expected_strings(hour_keys, kind, 64)
    urls = np.concatenate([b["url"], b["urll"][:, None].view(np.uint8)
                           .reshape(-1, 4)], axis=1)[keep]
    # url.count(b'e') per row, carried as the length of a string of that
    # many bytes (computed once per distinct url)
    _, counts = _expected_strings(
        urls, lambda k: b"e" * bytes(k[:int(k[40:].view(np.int32)[0])])
        .count(b"e"), 40)
    want = [b["auction"][keep], b["bidder"][keep], eur[keep], kd, kl,
            b["ts"][keep], b["url"][keep], b["urll"][keep],
            counts.astype(np.int32)]
    kinds = sorted({bytes(r[:ln]).decode() for r, ln in zip(kd, kl)})
    return _ring_check("q14", n, overflow, leaves, want,
                       f"{int(keep.sum())} of {keep.size} bids kept by "
                       f"0.908 * price, bidTimeType {kinds} by the hour, "
                       "count_char(url, 'e') = url.count('e')")


def check_bid_strings(eng, cap: int) -> str:
    """The ring against numpy and Python over the consumed bids: the LIKE
    and OR filter by ``re`` and bytes methods, substr, the two concats,
    trim and ltrim by Python, year and doy by datetime, the float64
    divide (IEEE) and the NUMERIC one (float64, rounded half to even at
    the engine scale), leaf for leaf."""
    import datetime as dt

    import numpy as np

    b = _consumed_bid_rows(eng, cap)
    n, overflow, leaves = _ring_planes(eng, "bid_strings")
    cw, uw = b["ch"].shape[1], b["url"].shape[1]
    keys = np.concatenate([b["ch"], b["chl"][:, None].view(np.uint8)
                           .reshape(-1, 4), b["url"],
                           b["urll"][:, None].view(np.uint8).reshape(-1, 4)],
                          axis=1)
    rx = k23_python_like

    def split(k):
        ch = bytes(k[:int(k[cw:cw + 4].view(np.int32)[0])])
        u0 = cw + 4
        u = bytes(k[u0:u0 + int(k[u0 + uw:u0 + uw + 4].view(np.int32)[0])])
        return ch, u

    def passes(k):
        ch, u = split(k)
        ok = rx(u, "https://%page1%item") and (
            ch.startswith(b"G") or b"page2" in u or ch.endswith(b"u"))
        return b"1" if ok else b""

    _, ok = _expected_strings(keys, passes, 1)
    keep = ok.astype(bool)
    k = keys[keep]
    pre = _expected_strings(k, lambda x: split(x)[0][:3], cw)
    cu = _expected_strings(k, lambda x: split(x)[0] + split(x)[1], cw + uw)
    ch = _expected_strings(k, lambda x: split(x)[0].strip(b" "), 64 + cw + 64)
    lu = _expected_strings(k, lambda x: split(x)[1].lstrip(b" "), uw)
    days = b["ts"][keep] // DAY_US

    def part(fn):
        u, inv = np.unique(days, return_inverse=True)
        vals = np.array([fn(dt.date(1970, 1, 1) + dt.timedelta(days=int(d)))
                         for d in u], np.int64)
        return vals[inv.reshape(-1)]

    price = b["price"][keep]
    p7 = np.round((price * 10**6).astype(np.float64) / 7e6 * 1e6) \
        .astype(np.int64)
    want = [b["auction"][keep], pre[0], pre[1], cu[0], cu[1], ch[0], ch[1],
            lu[0], lu[1], part(lambda d: d.year),
            part(lambda d: d.timetuple().tm_yday),
            price.astype(np.float64) / 3.0, p7]
    return _ring_check("bid_strings", n, overflow, leaves, want,
                       f"{int(keep.sum())} of {keep.size} bids kept by LIKE "
                       "and the ORs; substr, ||, trim, ltrim, year, doy and "
                       "the two divides")


def check_avg_bid(eng, cap: int) -> str:
    """The MV against numpy over the consumed bids, per auction: avg_price
    as the exact int64 sum over the count in float64 (within 1e-12
    relative), avg_price_eur as the NUMERIC sum of 0.908 * price divided
    with truncation toward zero (exact), count(*) exact."""
    import numpy as np

    b = _consumed_bid_rows(eng, cap)
    entry = eng.catalog.get("avg_bid")
    st = eng.jobs[0].states[entry.mv_state_index[0]]
    occ = st.table.occupied.cpu().numpy()
    got = [v.cpu().numpy()[occ] for v in st.values]
    keys, inv = np.unique(b["auction"], return_inverse=True)
    inv = inv.reshape(-1)
    cnt = np.bincount(inv).astype(np.int64)
    s = np.zeros(keys.size, np.int64)
    np.add.at(s, inv, b["price"])
    se = np.zeros(keys.size, np.int64)
    np.add.at(se, inv, _price_eur(b["price"]))
    order = np.argsort(got[0])
    got = [g[order] for g in got]
    if not np.array_equal(got[0], keys):
        fail(f"avg_bid holds {got[0].size} auctions, numpy {keys.size}")
    avg = s.astype(np.float64) / cnt.astype(np.float64)
    rel = float(np.max(np.abs(got[1] - avg) / np.abs(avg)))
    if got[1].dtype != np.float64 or rel > 1e-12:
        fail(f"avg_bid avg_price differs from numpy (max rel err {rel})")
    eur = np.sign(se) * (np.abs(se) // cnt)
    if not np.array_equal(got[2], eur) or not np.array_equal(got[3], cnt):
        fail("avg_bid avg_price_eur or bids differs from numpy")
    return (f"MV equals numpy over {b['price'].size} bids: {keys.size} "
            f"auctions, avg_price within {rel:.2e} relative (1e-12 allowed), "
            "avg_price_eur and bids exact")


SCALAR_CHECKS = {"q14": check_q14, "bid_strings": check_bid_strings,
                 "avg_bid": check_avg_bid}


def phase_sql_main_path(torch, device, query: str, ddl: list[str],
                        cfg: dict, watch: tuple, check, unit: str = "bid"):
    """``ddl`` at bench.py's sizes ``cfg``: 9 warm-up barriers, then 32
    timed barriers of 8 chunks with the launch counters taken over the
    timed window (``watch``: the slice's kernels, printed per chunk), one
    profiled window, the counter audit, and the MV checked by
    ``check(eng, cap)``: a message, or a message and a dict of what it
    found, returned as the third value."""
    from risingwave_tpu_torch import kernels
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig

    cuda = device.type == "cuda"
    barriers = BARRIERS if cuda else 2
    eng = Engine(PlannerConfig(**cfg), device=device)
    for stmt in ddl:
        eng.execute(stmt)
    eng.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1000000")
    eng.execute("ALTER SYSTEM SET snapshot_interval_checkpoints = 8")
    eng.tick(barriers=WARMUP_BARRIERS if cuda else 1,
             chunks_per_barrier=CHUNKS_PER_BARRIER)
    if cuda:
        torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    eng.tick(barriers=barriers, chunks_per_barrier=CHUNKS_PER_BARRIER)
    if cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    cap = cfg["chunk_capacity"]
    chunks = barriers * CHUNKS_PER_BARRIER
    rate = chunks * cap / dt
    mine = {k: launches[k] / chunks for k in watch if launches[k]}
    print(f"[main] {query} {chunks * cap} {unit} rows in {dt:.3f} s = "
          f"{rate:.0f} rows/s; the slice's kernel launches per chunk {mine}; "
          f"port kernel launches {sum(launches.values()) / chunks:.2f} per "
          f"chunk", flush=True)
    if cuda:
        per_chunk = profile_window(torch, eng, query)
        print(f"[main] {query} launches per chunk "
              f"{'not measured' if per_chunk is None else f'{per_chunk:.1f}'}"
              f" (all CUDA kernels, profiled window)", flush=True)
    eng.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1")
    eng.tick(barriers=1, chunks_per_barrier=0)
    got = check(eng, cap)
    msg, info = got if isinstance(got, tuple) else (got, {})
    print(f"[check] {query} {msg}", flush=True)
    del eng
    if cuda:
        torch.cuda.empty_cache()
    return launches, rate, info



# ---------------------------------------------------------------------------
# retractable min/max (K6m), EMIT ON WINDOW CLOSE (K7e), string min/max

SLICE11_BID = """
CREATE SOURCE bid (
    auction BIGINT, bidder BIGINT, price BIGINT,
    channel VARCHAR, url VARCHAR, date_time TIMESTAMP,
    WATERMARK FOR date_time AS date_time - INTERVAL '4' SECOND
) WITH (connector = 'nexmark', nexmark.table = 'bid',
        nexmark.event.rate = '{rate}');
"""
#: the person source with the two columns person_states reads
SLICE11_PERSON = """
CREATE SOURCE person (
    id BIGINT, name VARCHAR, city VARCHAR, state VARCHAR,
    date_time TIMESTAMP,
    WATERMARK FOR date_time AS date_time - INTERVAL '4' SECOND
) WITH (connector = 'nexmark', nexmark.table = 'person',
        nexmark.event.rate = '{rate}');
"""
SLICE11_SQL = {
    # Nexmark q5's HOP windows (bench.py's q5) with q7's max(price): the
    # pane plan's global agg keeps max(price) as materialized input (K6m)
    "q5_max": """
CREATE MATERIALIZED VIEW bench_mv AS
SELECT auction, window_start, max(price) AS max_price, count(*) AS bids
FROM HOP(bid, date_time, INTERVAL '2' SECOND, INTERVAL '10' SECOND)
GROUP BY auction, window_start;
""",
    # a closing 1 s TUMBLE keyed by auction: final rows reach the ring only
    # when their window closes (K7e)
    "q7_eowc": """
CREATE MATERIALIZED VIEW bench_mv AS
SELECT auction, window_start, max(price) AS max_price, count(*) AS bids
FROM TUMBLE(bid, date_time, INTERVAL '1' SECOND)
GROUP BY auction, window_start
EMIT ON WINDOW CLOSE;
""",
    # min/max over the 4-byte state (the packed int64 state) grouped by
    # the string city (K5's string keys)
    "person_states": """
CREATE MATERIALIZED VIEW bench_mv AS
SELECT city, min(state) AS lo, max(state) AS hi, count(*) AS persons
FROM person GROUP BY city;
""",
}
SLICE11_QUERIES = tuple(SLICE11_SQL)
#: events/s at bench sizes: q7_eowc's 100,000 lets about 25 one-second
#: windows close over the run (at 1,000,000 the run covers ~3 s)
SLICE11_RATE = {"q5_max": "1000000", "q7_eowc": "100000",
                "person_states": "1000000"}
#: events/s of the card-against-CPU runs (chunk 256: q7_eowc's windows
#: must close within 6 barriers)
SLICE11_PARITY_RATE = {"q5_max": "10000", "q7_eowc": "500",
                       "person_states": "10000"}
SLICE11_PARITY_CONFIG = dict(chunk_capacity=256, agg_table_size=1 << 10,
                             agg_emit_capacity=16, mv_table_size=1 << 12,
                             mv_ring_size=1 << 14)


def _slice11_ddl(query: str, rate: str) -> list[str]:
    src = SLICE11_PERSON if query == "person_states" else SLICE11_BID
    return [src.format(rate=rate), SLICE11_SQL[query]]


def _minput_case(torch, size: int, B: int, cap: int, g):
    """A K6m input at q5_max's shapes: buckets filled at random (a 64th
    of the slots full), and a chunk of ``cap`` rows: inserts (70% on 512
    hot slots), deletes of stored (slot, value) pairs, deletes of absent
    values (misses), +v/-v pairs inside the chunk, inactive rows (NULL or
    filtered values) and 2% of the rows on slots reclaimed this chunk."""
    fill = torch.rand(size, generator=g)
    fill[torch.randint(0, size, (max(size // 64, 1),), generator=g)] = 1.0
    occ = torch.rand((size, B), generator=g) < fill[:, None]
    vals = torch.randint(0, 50, (size, B), generator=g)
    hot = torch.randint(0, size, (512,), generator=g)
    n_ins = cap // 2
    n_del = cap // 4
    n_miss = cap // 16
    n_pair = (cap - n_ins - n_del - n_miss) // 2
    ins_slots = torch.where(torch.rand(n_ins, generator=g) < 0.7,
                            hot[torch.randint(0, 512, (n_ins,),
                                              generator=g)],
                            torch.randint(0, size, (n_ins,), generator=g))
    ins_v = torch.randint(0, 50, (n_ins,), generator=g)
    stored = occ.nonzero()
    pick = stored[torch.randint(0, stored.shape[0], (n_del,), generator=g)]
    del_slots, del_v = pick[:, 0], vals[pick[:, 0], pick[:, 1]]
    miss_slots = torch.randint(0, size, (n_miss,), generator=g)
    miss_v = torch.full((n_miss,), 10**6, dtype=torch.int64)
    pair_slots = hot[torch.randint(0, 512, (n_pair,), generator=g)]
    pair_v = torch.randint(0, 50, (n_pair,), generator=g)
    slots = torch.cat([ins_slots, del_slots, miss_slots, pair_slots,
                       pair_slots])
    v = torch.cat([ins_v, del_v, miss_v, pair_v, pair_v])
    signs = torch.cat([torch.ones(n_ins, dtype=torch.int64),
                       -torch.ones(n_del + n_miss, dtype=torch.int64),
                       torch.ones(n_pair, dtype=torch.int64),
                       -torch.ones(n_pair, dtype=torch.int64)])
    n = slots.shape[0]
    pad = cap - n
    slots = torch.cat([slots, torch.zeros(pad, dtype=torch.int64)])
    v = torch.cat([v, torch.zeros(pad, dtype=torch.int64)])
    signs = torch.cat([signs, torch.zeros(pad, dtype=torch.int64)])
    order = torch.randperm(cap, generator=g)
    slots, v, signs = slots[order], v[order], signs[order]
    active = (torch.rand(cap, generator=g) < 0.95) & (signs != 0)
    ins_pos = torch.where(torch.rand(cap, generator=g) < 0.02, slots,
                          torch.full_like(slots, size))
    return (vals, occ, slots.to(torch.int32), v, signs.to(torch.int8),
            active, ins_pos.to(torch.int32))


def phase_slice11_kernels(torch, device, timer, scale):
    """K6m and K7e against their plain versions on CPU copies, exactly,
    and the EowcSortExecutor on the card against a CPU copy: K6m's update
    at q5_max's shapes (buckets of 64 values over 2^18 slots, a chunk of
    5 x 2 x 4096 rows: the pane agg's U-/U+ flush through the hop's five
    copies) with every case of the CPU tests (hits, misses, +v/-v pairs,
    full buckets, inactive rows, reclaimed slots), K6m's refresh over
    4096 emitted slots, K7e over 2^18 slots with more than 4096 closed,
    before any watermark and as the drain's count (k = 0); each timed
    with its plain version on the card and its bound."""
    from risingwave_tpu_torch.common.compact import mask_indices_plain
    from risingwave_tpu_torch.stream import hash_agg as H
    from risingwave_tpu_torch.stream.watermark import EowcSortExecutor

    g = torch.Generator().manual_seed(61)
    size, B = (1 << 18) // scale, 64
    cap = 5 * 2 * 4096 // scale
    E = 4096 // scale
    case = _minput_case(torch, size, B, cap, g)
    vals, occ, slots, v, signs, active, ins_pos = case
    cpu = [t.clone() for t in (vals, occ)]
    cnt_cpu = [torch.zeros((), dtype=torch.int64) for _ in range(2)]
    H.minput_update_plain(*cpu, slots, v, signs, active, ins_pos, *cnt_cpu)
    dev = [t.to(device) for t in case]
    cnt = [torch.zeros((), dtype=torch.int64, device=device)
           for _ in range(2)]
    H.minput_update(*dev[:2], *dev[2:], *cnt)
    pairs = [("minput vals", dev[0].cpu(), cpu[0]),
             ("minput occ", dev[1].cpu(), cpu[1]),
             ("minput overflow", cnt[0].cpu(), cnt_cpu[0]),
             ("minput inconsistency", cnt[1].cpu(), cnt_cpu[1])]
    err = max_abs_err(torch, pairs)
    n_over, n_miss = int(cnt_cpu[0]), int(cnt_cpu[1])
    if n_over == 0 or n_miss == 0:
        fail(f"K6m case lacks overflow ({n_over}) or misses ({n_miss})")
    # every timed call starts from the case's buckets (a copy of its own,
    # made before the timing), so each meets the mix counted above
    n_it = 20
    base = [t.to(device) for t in case[:2]]
    pool = [[t.clone() for t in base] for _ in range(n_it + 1)]
    args = dev[2:]

    def restore():
        for w in pool:
            for t, b in zip(w, base):
                t.copy_(b)

    def kernel(i):
        H.minput_update_cuda(*pool[i], *args, *cnt) \
            if device.type == "cuda" \
            else H.minput_update_plain(*pool[i], *args, *cnt)

    ms = timer(kernel, n_it)
    restore()
    plain_ms = timer(lambda i: H.minput_update_plain(*pool[i], *args, *cnt),
                     5, prefill_ms=20.0)
    del pool
    n_act = int(active.sum())
    n_reset = int((ins_pos < size).sum())
    _, s_ins, s_del = H.minput_survivors(slots, v, signs, active)
    n_ins, n_del = int(s_ins.sum()), int(s_del.sum())
    # every row's slot, value, sign, flag and reclaimed slot read (18 B);
    # a reclaimed slot's B occupancy bytes cleared; a surviving insert
    # reads its bucket's B occupancy bytes and, where it finds a free
    # entry, writes it (9 B); a surviving delete reads the B occupancy
    # bytes and B values and, where it matches, clears one byte; a
    # cancelled pair reads no bucket
    b_upd = bound(cap * 18 + n_reset * B + n_ins * B + (n_ins - n_over) * 9
                  + n_del * B * 9 + (n_del - n_miss), (n_ins + n_del) * B * 2)
    print(f"[agg_minput] exact on a chunk of {cap} rows ({n_act} active: "
          f"{n_ins} inserts and {n_del} deletes survive the +v/-v pairs; "
          f"{n_miss} misses, {n_over} inserts into full buckets, {n_reset} "
          f"rows on reclaimed slots) over {size} x {B} buckets; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms (each call on a copy of "
          f"the case's buckets), bound {b_upd[0]:.5f} ms", flush=True)
    out = {"agg_minput": kernel_entry(
        "agg_minput.cu", "risingwave_tpu/stream/hash_agg.py:790", ms,
        plain_ms, b_upd, None, err)}
    out["agg_minput"]["at_shapes"] = {
        "cap": cap, "size": size, "B": B, "active": n_act, "inserts": n_ins,
        "deletes": n_del, "misses": n_miss, "overflow": n_over,
        "reclaimed": n_reset}

    # -- K6m refresh ------------------------------------------------------
    emit = torch.sort(torch.randperm(size, generator=g)[:E]).values
    emit[-max(E // 16, 1):] = size                  # sentinel tail
    emit = emit.to(torch.int32)
    pairs = []
    for mode in ("min", "max"):
        prim_cpu = torch.full((size,), 7, dtype=torch.int64)
        H.minput_refresh_plain(prim_cpu, cpu[0], cpu[1], emit, mode)
        prim = torch.full((size,), 7, dtype=torch.int64, device=device)
        H.minput_refresh(prim, dev[0], dev[1], emit.to(device), mode)
        pairs.append((f"refresh {mode}", prim.cpu(), prim_cpu))
    for dt in (torch.int32, torch.float64):
        v2 = cpu[0].to(dt)
        prim_cpu = torch.zeros(size, dtype=dt)
        H.minput_refresh_plain(prim_cpu, v2, cpu[1], emit, "max")
        prim = torch.zeros(size, dtype=dt, device=device)
        H.minput_refresh(prim, v2.to(device), dev[1], emit.to(device), "max")
        pairs.append((f"refresh max {dt}", prim.cpu(), prim_cpu))
    err = max_abs_err(torch, pairs)
    emit_d = emit.to(device)
    prim = torch.zeros(size, dtype=torch.int64, device=device)
    ms = timer(lambda i: H.minput_refresh(prim, dev[0], dev[1], emit_d,
                                          "max"), 200)
    plain_ms = timer(lambda i: H.minput_refresh_plain(prim, dev[0], dev[1],
                                                      emit_d, "max"), 20)
    # the slot list read; a live slot's bucket read and its cache written
    n_live = int((emit < size).sum())
    b_ref = bound(E * 4 + n_live * (B * 9 + 8), n_live * B)
    print(f"[minput_refresh] exact on {E} emitted slots ({n_live} live, "
          f"a sentinel tail; min and max over int64, max over int32 and "
          f"float64); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ref[0]:.5f} ms",
          flush=True)
    out["minput_refresh"] = kernel_entry(
        "agg_minput.cu", "risingwave_tpu/stream/hash_agg.py:879", ms,
        plain_ms, b_ref, None, err)

    # -- K7e --------------------------------------------------------------
    occ_t = torch.rand(size, generator=g) < 0.6
    base = 1_436_918_400_000_000
    key = base + torch.randint(0, 30, (size,), generator=g) * 1_000_000
    key_null = torch.rand(size, generator=g) < 0.01
    lag = 1_000_000
    wm = torch.tensor(base + 10 * 1_000_000)
    none = torch.tensor(-(1 << 63))
    pairs = []
    for tag, w, k, nul in (("closed", wm, E, key_null),
                           ("no NULL plane", wm, E, None),
                           ("no watermark", none, E, key_null),
                           ("pending count", wm, 0, key_null)):
        want = H.eowc_slots_plain(occ_t, key, nul, lag, w, k)
        got = H.eowc_slots(occ_t.to(device), key.to(device),
                           None if nul is None else nul.to(device), lag,
                           w.to(device), k)
        pairs += [(f"eowc slots {tag}", got[0].cpu(), want[0]),
                  (f"eowc count {tag}", got[1].cpu(), want[1])]
    err = max_abs_err(torch, pairs)
    n_closed = int(H.eowc_slots_plain(occ_t, key, key_null, lag, wm, 0)[1])
    if n_closed <= E:
        fail(f"K7e case closes {n_closed} slots, not more than {E}")
    d = [occ_t.to(device), key.to(device), key_null.to(device)]
    wm_d = wm.to(device)
    ms = timer(lambda i: H.eowc_slots(d[0], d[1], d[2], lag, wm_d, E), 200)

    def plain(i):
        closed = H.closed_mask(d[0], d[1], d[2], lag, wm_d)
        return mask_indices_plain(closed, E, size), closed.sum()

    plain_ms = timer(plain, 50)
    # each slot's occupancy, key and NULL flag read once; E slots written
    b_e = bound(size * 10 + E * 4, size * 6)
    print(f"[agg_eowc] exact over {size} slots ({n_closed} closed, the "
          f"first {E} taken; without a NULL plane, before any watermark, and "
          f"the drain's count alone); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b_e[0]:.5f} ms", flush=True)
    out["agg_eowc"] = kernel_entry(
        "agg_eowc.cu", "risingwave_tpu/stream/hash_agg.py:961", ms, plain_ms,
        b_e, None, err)

    # -- the EOWC sort: K7 + torch.sort + gather, no kernel of its own -----
    from risingwave_tpu_torch.common.chunk import Chunk
    from risingwave_tpu_torch.common.types import DataType, Field, Schema
    from risingwave_tpu_torch.compat import state_mismatches, state_to_numpy
    from risingwave_tpu_torch.stream.message import Watermark

    schema = Schema((Field("ts", DataType.INT64), Field("v", DataType.INT64)))
    S, C = (1 << 16) // scale, 8192 // scale
    exs = [EowcSortExecutor(schema, 0, S, E) for _ in range(2)]
    sts = [exs[0].init_state(device), exs[1].init_state("cpu")]
    emitted = [[], []]
    chunks = []
    for c in range(8):
        ts = c * 1000 + torch.randint(0, 4000, (C,), generator=g)
        vv = torch.arange(c * C, (c + 1) * C)
        valid = torch.rand(C, generator=g) < 0.9
        chunks.append((ts, vv, valid))
    for c, (ts, vv, valid) in enumerate(chunks):
        for i, dv in enumerate((device, torch.device("cpu"))):
            ch = Chunk((ts.to(dv), vv.to(dv)),
                       torch.zeros(C, dtype=torch.int8, device=dv),
                       valid.to(dv), schema)
            sts[i], _ = exs[i].apply(sts[i], ch)
            sts[i] = exs[i].on_watermark(sts[i], Watermark(
                0, torch.tensor(c * 1000, device=dv)))
            while int(exs[i].pending_flush(sts[i])):
                sts[i], o = exs[i].flush(sts[i], c)
                emitted[i].append(o.columns[1][o.valid].cpu())
    bad = state_mismatches(state_to_numpy(sts[1]), sts[0])
    got = torch.cat(emitted[0]) if emitted[0] else torch.zeros(0)
    want = torch.cat(emitted[1]) if emitted[1] else torch.zeros(0)
    if bad or not torch.equal(got, want) or got.numel() == 0:
        fail(f"EowcSortExecutor on the card differs from the CPU: {bad[:4]}")
    ch = Chunk((chunks[0][0].to(device), chunks[0][1].to(device)),
               torch.zeros(C, dtype=torch.int8, device=device),
               chunks[0][2].to(device), schema)
    st = exs[0].init_state(device)
    apply_ms = timer(lambda i: exs[0].apply(st, ch), 50)
    st = exs[0].on_watermark(st, Watermark(0, torch.tensor(10**9,
                                                           device=device)))
    flush_ms = timer(lambda i: exs[0].flush(st, 0), 50)
    # bounds from this chunk: apply reads the pool's free mask (1 B a
    # slot), the chunk's valid and op (2 B a row) and each valid row's two
    # int64 columns, and writes them and their valid byte into the pool;
    # the flush reads the live rows' timestamps (the sort key) and moves
    # the first min(E, live) of them (16 B read, 16 B + op and valid
    # written, their pool byte freed)
    live = int(chunks[0][2].sum())
    b_apply = bound(S + 2 * C + live * 33, C * 10)
    b_flush = bound(live * 8 + min(E, live) * 35, live * 20)
    print(f"[eowc_sort] EowcSortExecutor (pool {S}, emit {E}, chunks of "
          f"{C}) equal to a CPU copy over 8 chunks, {got.numel()} rows "
          f"emitted in timestamp order and the pool; apply {apply_ms:.4f} "
          f"ms (K7 over the free mask + the row scatter), bound "
          f"{b_apply[0]:.5f} ms; flush {flush_ms:.4f} ms (torch.sort + "
          f"gather of {live} live rows), bound {b_flush[0]:.5f} ms",
          flush=True)
    out["agg_eowc"]["eowc_sort"] = {"pool": S, "emit": E, "chunk": C,
                                    "apply_ms": apply_ms,
                                    "flush_ms": flush_ms,
                                    "apply_bound_ms": b_apply[0],
                                    "flush_bound_ms": b_flush[0],
                                    "rows": got.numel()}
    return out


def _consumed_persons(eng, cap: int) -> dict:
    """City and state (bytes, lens) of every person the job consumed."""
    import numpy as np

    reader = eng.jobs[0].source
    inner = getattr(reader, "inner", reader)
    out = {"city": [], "cityl": [], "state": [], "statel": []}
    for i in range(reader.offset // cap):
        c = inner.gen.gen_persons(i * cap, cap).columns
        for k, x in (("city", c[4].data), ("cityl", c[4].lens),
                     ("state", c[5].data), ("statel", c[5].lens)):
            out[k].append(x.cpu().numpy())
    return {k: np.concatenate(v) for k, v in out.items()}


def check_q5_max(eng, bids) -> str:
    """The MV against numpy per (auction, hop window): max(price) and the
    bid count."""
    import numpy as np

    k = WINDOW_US // HOP_SLIDE_US
    ws0 = bids["ts"] - bids["ts"] % HOP_SLIDE_US
    base = int(ws0.min()) - (k - 1) * HOP_SLIDE_US
    n_win = (int(ws0.max()) - base) // HOP_SLIDE_US + 1
    win = np.concatenate([(ws0 - i * HOP_SLIDE_US - base) // HOP_SLIDE_US
                          for i in range(k)])
    key = np.tile(bids["auction"], k) * n_win + win
    price = np.tile(bids["price"], k)
    uniq, inv, counts = np.unique(key, return_inverse=True,
                                  return_counts=True)
    hi = np.full(uniq.shape[0], np.iinfo(np.int64).min)
    np.maximum.at(hi, inv.reshape(-1), price)
    rows = eng.execute("SELECT auction, window_start, max_price, bids "
                       "FROM bench_mv")
    got = np.asarray([(int(a) * n_win + (int(w) - base) // HOP_SLIDE_US,
                       int(m), int(c)) for a, w, m, c in rows], np.int64)
    got = got[np.argsort(got[:, 0])] if len(got) else got.reshape(0, 3)
    if got.shape[0] != uniq.shape[0] or not (
            np.array_equal(got[:, 0], uniq) and np.array_equal(got[:, 1], hi)
            and np.array_equal(got[:, 2], counts)):
        fail(f"q5_max MV ({got.shape[0]} rows) differs from the numpy hop "
             f"max/counts ({uniq.shape[0]} (auction, window) pairs)")
    return (f"MV equals numpy max(price) and count per (auction, "
            f"window_start) over {bids['auction'].shape[0]} bids "
            f"({uniq.shape[0]} rows)")


def check_q7_eowc(eng, bids) -> tuple[str, dict]:
    """The ring against numpy: every (auction, window) of a CLOSED window
    (window_start + 1 s <= the watermark) exactly once, with its final
    max(price) and count, and no row of an open window.  Returns the
    message and ``{"windows": closed, "rows": emitted}``."""
    import numpy as np

    from risingwave_tpu_torch.stream.hash_agg import HashAggExecutor

    job = eng.jobs[0]
    agg = next(i for i, x in enumerate(job.fragment.executors)
               if isinstance(x, HashAggExecutor))
    wm = int(job.states[agg].wm)
    n, overflow, leaves = _ring_planes(eng, "bench_mv")
    if overflow:
        fail(f"q7_eowc ring overflowed ({overflow} rows)")
    ws = bids["ts"] - bids["ts"] % 1_000_000
    closed = ws + 1_000_000 <= wm
    key = bids["auction"][closed] * (1 << 20) + (ws[closed] // 1_000_000
                                                 - ws.min() // 1_000_000)
    uniq, inv, counts = np.unique(key, return_inverse=True,
                                  return_counts=True)
    hi = np.full(uniq.shape[0], np.iinfo(np.int64).min)
    np.maximum.at(hi, inv.reshape(-1), bids["price"][closed])
    got_key = leaves[0] * (1 << 20) + (leaves[1] // 1_000_000
                                       - ws.min() // 1_000_000)
    order = np.argsort(got_key, kind="stable")
    got_key = got_key[order]
    if got_key.shape[0] != uniq.shape[0] or not (
            np.array_equal(got_key, uniq)
            and np.array_equal(leaves[2][order], hi)
            and np.array_equal(leaves[3][order], counts)):
        fail(f"q7_eowc ring ({n} rows) differs from numpy over the closed "
             f"windows ({uniq.shape[0]} (auction, window) pairs)")
    n_windows = int(np.unique(ws[closed]).shape[0])
    return (f"ring equals numpy max/count per (auction, window) of the "
            f"{n_windows} closed windows over {bids['ts'].shape[0]} bids: "
            f"{n} rows, each once, none of an open window",
            {"windows": n_windows, "rows": n})


def check_person_states(eng, cap: int) -> str:
    """The MV against numpy per city: the least and greatest state string
    (byte order) and the person count."""
    import numpy as np

    p = _consumed_persons(eng, cap)

    def text(data, lens, i):
        return bytes(data[i, :lens[i]]).decode()

    want: dict = {}
    for i in range(p["cityl"].shape[0]):
        c = text(p["city"], p["cityl"], i)
        st = text(p["state"], p["statel"], i)
        lo, hi, n = want.get(c, (st, st, 0))
        want[c] = (min(lo, st), max(hi, st), n + 1)
    got = {r[0]: (r[1], r[2], int(r[3]))
           for r in eng.execute("SELECT * FROM bench_mv")}
    if got != want:
        fail(f"person_states MV differs from numpy: {sorted(got.items())[:3]}"
             f" vs {sorted(want.items())[:3]}")
    return (f"MV equals numpy min/max(state) and count per city over "
            f"{p['cityl'].shape[0]} persons ({len(want)} cities)")


def _slice11_config(scale: int) -> dict:
    """bench.py's sizes (chunk 8192, agg table and MV 2^18, emit 4096)
    with a ring of 2^21."""
    cfg = {k: v // scale for k, v in BENCH_CONFIG.items()}
    cfg["mv_ring_size"] = (1 << 21) // scale
    return cfg


SLICE11_KERNELS = ("agg_minput", "minput_refresh", "agg_eowc")
SLICE11_CHECKS = {
    "q5_max": lambda eng, cap: check_q5_max(eng, _consumed_bids(eng, cap)),
    "q7_eowc": lambda eng, cap: check_q7_eowc(eng,
                                              _consumed_bids(eng, cap)),
    "person_states": check_person_states,
}


# ---------------------------------------------------------------------------
# sinks (K22b), MV-on-MV cascades, SHOW/DROP and the append-only dedup (K19b)

#: the slice's paths, run after the durable ones
SINK_PATHS = ("q1_sink", "q5_cascade", "q5_cascade durable", "dedup_sink")
#: bench's q1 into a blackhole sink (the parser, a copy of the reference's,
#: reads a bare ``FROM bid WITH`` as the table alias ``with``: the alias
#: is explicit)
Q1_SINK_SQL = ("CREATE SINK q1_sink AS SELECT auction, bidder, 0.908 * price "
               "AS price, date_time FROM bid AS bid WITH (connector = "
               "'blackhole');")
Q5_SQL = QUERY_SQL["q5"].replace("bench_mv", "q5")
#: barriers of q5 before the cascade is created over it
Q5_BEFORE_CASCADE = 4
#: dedup_sink's bid rate: q7_eowc's 100,000 events/s, so that the run
#: covers ~29 s of event time and two 10 s windows close
DEDUP_RATE = "100000"
#: dedup_sink's table: the run sees ~26,000 (window, auction) keys, so at
#: 2^18 slots its rehash threshold (a quarter of the slots tombstoned)
#: could not be reached; at 2^16 the two closed windows pass it
DEDUP_TABLE = 1 << 16
SINK_PATH_KERNELS = {
    "q1_sink": ("nexmark_bids", "sink_ring"),
    "q5_cascade": PATH_KERNELS["q5"] + ("sink_ring",),
    "q5_cascade durable": PATH_KERNELS["q5"] + ("sink_ring",
                                                "shadow_digest"),
    "dedup_sink": ("nexmark_bids", "hop_window", "hash64", "probe",
                   "table_sweep", "sink_ring"),
}


def _sink_chunk(torch, device, cap: int, p_valid: float, g):
    """A changelog chunk of every leaf kind K22b moves: int64, NUMERIC (a
    scaled int64), a nullable int64, a nullable VARCHAR(8) and a
    VARCHAR(64) with random bytes past their lengths (8- and 16-byte
    words), a nullable BOOLEAN and a VARCHAR(5) (1-byte words); random
    ops and ``p_valid`` of the rows valid."""
    from risingwave_tpu_torch.common.chunk import Chunk, NCol, StrCol
    from risingwave_tpu_torch.common.types import DataType, Field, Schema
    from risingwave_tpu_torch.stream.spill import chunk_to

    def f(name, t, nullable=False, w=None):
        kw = {"str_width": w} if w else {}
        return Field(name, t, nullable=nullable, **kw)

    schema = Schema((f("k", DataType.INT64), f("p", DataType.DECIMAL),
                     f("n", DataType.INT64, True),
                     f("s", DataType.VARCHAR, True, 8),
                     f("t", DataType.VARCHAR, False, 64),
                     f("b", DataType.BOOLEAN, True),
                     f("u", DataType.VARCHAR, False, 5)))

    def i64():
        return torch.randint(-2**62, 2**62, (cap,), generator=g)

    def nulls(p=0.3):
        return torch.rand(cap, generator=g) < p

    def strs(w):
        return StrCol(torch.randint(0, 256, (cap, w), generator=g,
                                    dtype=torch.uint8),
                      torch.randint(0, w + 1, (cap,), generator=g,
                                    dtype=torch.int32))

    cols = [i64(), i64(), NCol(i64(), nulls()), NCol(strs(8), nulls()),
            strs(64), NCol(nulls(0.5), nulls(0.2)), strs(5)]
    ops = torch.randint(0, 4, (cap,), generator=g, dtype=torch.int8)
    chunk = Chunk(cols, ops, torch.rand(cap, generator=g) < p_valid, schema)
    return schema, chunk_to(chunk, device)


def _dedup_rows(torch, device, cap: int, g, window: int, n_auctions: int):
    """A (window_start, auction, v) chunk: three 10 s windows and
    ``n_auctions`` auctions (duplicates within and across chunks)."""
    from risingwave_tpu_torch.common.chunk import Chunk
    from risingwave_tpu_torch.common.types import DataType, Field, Schema

    schema = Schema((Field("window_start", DataType.TIMESTAMP),
                     Field("auction", DataType.INT64),
                     Field("v", DataType.INT64)))
    ws = torch.randint(0, 3, (cap,), generator=g) * window
    auction = torch.randint(0, n_auctions, (cap,), generator=g)
    v = torch.arange(cap, dtype=torch.int64)
    valid = torch.rand(cap, generator=g) < 0.95
    return schema, Chunk([ws.to(device), auction.to(device), v.to(device)],
                         torch.zeros(cap, dtype=torch.int8, device=device),
                         valid.to(device), schema)


def phase_sink_kernels(torch, device, timer, scale):
    """K22b against ``sink_append_plain`` on the same card tensors,
    exactly: 8192-row chunks of every leaf kind (``_sink_chunk``) into a
    2^14 ring that they wrap, and a backfill chunk of 2^18 rows (2% valid)
    into a 2^21 ring; then timed at q1_sink's shape (8192 rows of 4 int64
    leaves and the op into the 2^23 ring).  K19b (no kernel of its own:
    K1, K3, the K4 sweep) on the card against a CPU copy: 8 chunks of
    (window_start, auction) keys with duplicates, a watermark that evicts
    two windows and the rehash past a quarter of tombstones, outputs and
    state exact; timed per chunk with K3's plain probe beside it."""
    from risingwave_tpu_torch.common.chunk import Chunk
    from risingwave_tpu_torch.common.tree import flatten
    from risingwave_tpu_torch.common.types import DataType, Field, Schema
    from risingwave_tpu_torch.expr.node import InputRef
    from risingwave_tpu_torch.state.hash_table import HashTable
    from risingwave_tpu_torch.stream.message import Watermark
    from risingwave_tpu_torch.stream.sink import (
        SinkExecutor, sink_append, sink_append_plain)
    from risingwave_tpu_torch.stream.spill import chunk_to
    from risingwave_tpu_torch.stream.top_n import AppendOnlyDedupExecutor

    def _leaves(st):
        return flatten(st)[0]

    g = torch.Generator().manual_seed(22)
    pairs = []
    cases = (("wrap", 8192 // scale, 0.7, (1 << 14) // scale, 4),
             ("backfill", (1 << 18) // scale, 0.02, (1 << 21) // scale, 1))
    for tag, cap, p, ring, steps in cases:
        schema, _ = _sink_chunk(torch, "cpu", 1, 1.0, g)
        ex = SinkExecutor(schema, None, ring_size=ring)
        a, b = ex.init_state(device), ex.init_state(device)
        for step in range(steps):
            _, chunk = _sink_chunk(torch, device, cap, p, g)
            sink_append(a.values, a.ops, a.cursor, chunk, ring)
            sink_append_plain(b.values, b.ops, b.cursor, chunk, ring)
        pairs += [(f"sink {tag} leaf {i}", x, y) for i, (x, y) in enumerate(
            zip(_leaves(a), _leaves(b)))]
        if tag == "wrap" and int(a.cursor) <= ring:
            fail("K22b's wrap case did not wrap the ring")
    err = max_abs_err(torch, pairs)
    # q1_sink's shape: 4 int64 columns and the op, every row valid
    ring, cap = (1 << 23) // scale, 8192 // scale
    schema = Schema(tuple(Field(n, DataType.INT64)
                          for n in ("auction", "bidder", "price", "ts")))
    cols = [torch.randint(0, 10**12, (cap,), generator=g).to(device)
            for _ in range(4)]
    chunk = Chunk(cols, torch.zeros(cap, dtype=torch.int8, device=device),
                  torch.ones(cap, dtype=torch.bool, device=device), schema)
    ex = SinkExecutor(schema, None, ring_size=ring)
    a, b = ex.init_state(device), ex.init_state(device)
    ms = timer(lambda i: sink_append(a.values, a.ops, a.cursor, chunk,
                                     ring), 200)
    plain_ms = timer(lambda i: sink_append_plain(b.values, b.ops, b.cursor,
                                                 chunk, ring), 20)
    b_ = sink_bound(cap, 4 * 8 + 1)
    print(f"[sink_ring] exact (every leaf kind across a ring wrap, and a "
          f"{(1 << 18) // scale}-row backfill chunk into a "
          f"{(1 << 21) // scale}-row ring); at q1_sink's shape ({cap} rows "
          f"x 4 int64 + op into {ring}): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b_[0]:.6f} ms ({b_[1]})", flush=True)
    out = {"sink_ring": kernel_entry(
        "sink_ring.cu", "risingwave_tpu/stream/sink.py:63", ms, plain_ms, b_,
        None, err)}

    # K19b on the card against a CPU copy
    size, cap = DEDUP_TABLE // scale, 8192 // scale
    n_auctions = 10_000 // scale
    schema, _ = _dedup_rows(torch, "cpu", 1, g, WINDOW_US, n_auctions)
    execs = [AppendOnlyDedupExecutor(
        schema, [InputRef(0), InputRef(1)], table_size=size,
        watermark_key_idx=0, watermark_lag=WINDOW_US) for _ in range(2)]
    sts = [execs[0].init_state(device), execs[1].init_state("cpu")]
    pairs = []

    def state_pairs(tag):
        # copies: both tables change in place after this
        return [(f"dedup {tag} {i}", x.to("cpu", copy=True), y.clone())
                for i, (x, y) in enumerate(zip(_leaves(sts[0]),
                                               _leaves(sts[1])))]

    chunks = []
    for step in range(8):
        _, chunk = _dedup_rows(torch, device, cap, g, WINDOW_US, n_auctions)
        chunks.append(chunk)
        outs = []
        for k, dev in enumerate((device, "cpu")):
            sts[k], o = execs[k].apply(sts[k], chunk_to(chunk, dev))
            outs.append(o.valid)
        pairs.append((f"dedup step {step} kept rows", outs[0].cpu(),
                      outs[1]))
    pairs += state_pairs("after the chunks")
    for k, dev in enumerate((device, "cpu")):
        wm = Watermark(0, torch.tensor(3 * WINDOW_US, device=dev))
        sts[k] = execs[k].on_watermark(sts[k], wm)
    pairs += state_pairs("after the watermark")
    tomb = int(sts[1].table.tombstone_count())
    if tomb <= size // 4:
        fail(f"K19b's case left {tomb} tombstones, not past {size // 4}")
    for k in range(2):
        sts[k] = execs[k].maybe_rehash(sts[k])
    pairs += state_pairs("after the rehash")
    err_d = max_abs_err(torch, pairs)
    if int(sts[1].table.tombstone_count()) != 0:
        fail("K19b's rehash left tombstones")
    # timed: one chunk into a fresh copy of the filled table each call
    ex = execs[0]
    fresh = sts[0]
    copies = [fresh._replace(table=fresh.table.clone()) for _ in range(40)]
    d_ms = timer(lambda i: ex.apply(copies[i % 40], chunks[i % 8]), 20)
    probe = HashTable._probe
    HashTable._probe = HashTable._probe_plain
    try:
        copies = [fresh._replace(table=fresh.table.clone())
                  for _ in range(40)]
        d_plain = timer(lambda i: ex.apply(copies[i % 40], chunks[i % 8]), 20)
    finally:
        HashTable._probe = probe
    n = int(chunks[0].valid.sum())
    # each valid row reads its 16 B key, reads or claims a slot (16 B of
    # keys, 2 B of flags) and writes its kept flag
    d_b = bound(cap + n * (16 + 18 + 1), n * 20)
    print(f"[append_only_dedup] K19b on the card equals a CPU copy (kept "
          f"rows, table, overflow) over 8 chunks, a watermark evicting two "
          f"windows ({tomb} tombstones) and the rehash; one chunk: "
          f"{d_ms:.4f} ms, with K3's plain probe {d_plain:.4f} ms, bound "
          f"{d_b[0]:.6f} ms", flush=True)
    out["append_only_dedup"] = {
        "route": "cuda", "source": "risingwave_tpu_torch/stream/top_n.py",
        "replaces": "risingwave_tpu/stream/top_n.py:441", "launches": 0,
        "max_abs_err": err_d, "ms": d_ms, "plain_ms": d_plain,
        "bound_ms": d_b[0], "bound_by": d_b[1], "library_ms": None,
        "composed_of": ["hash64", "probe", "table_sweep"]}
    return out


def _time_deliver(ex, log: list) -> None:
    """Record the host seconds of each ``deliver`` of a sink executor."""
    inner = ex.deliver

    def deliver(state, epoch, commit=True):
        t0 = time.perf_counter()
        out = inner(state, epoch, commit)
        log.append(time.perf_counter() - t0)
        return out

    ex.deliver = deliver


def _count_snapshots(job, log: list) -> None:
    inner = job._snapshot_commit

    def snapshot(*a, **k):
        log.append(a[0])
        return inner(*a, **k)

    job._snapshot_commit = snapshot


def sink_bound(rows: int, row_bytes: float) -> tuple[float, str]:
    """K22b's bound: each appended row's leaves and op read once and
    written once."""
    return bound(2 * rows * row_bytes, 0)


def _sink_row_bytes(st) -> float:
    """Bytes one ring row of a sink state holds (every leaf and the
    op)."""
    return sum(row_bytes(v) for v in st.values) + 1


def _timed_window(torch, eng, device, query: str, unit_rows: int,
                  barriers: int, sink_state):
    """The launch counters over ``barriers`` timed barriers of 8 chunks,
    then one profiled window: K22b's device ms per launch there against
    its bound from the rows it appended.  ``sink_state()`` is the sink's
    current state.  Returns (launches, rows/s)."""
    from risingwave_tpu_torch import kernels

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    eng.tick(barriers=barriers, chunks_per_barrier=CHUNKS_PER_BARRIER)
    if cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    chunks = barriers * CHUNKS_PER_BARRIER
    rate = chunks * unit_rows / dt
    print(f"[main] {query} {chunks * unit_rows} bid rows in {dt:.3f} s = "
          f"{rate:.0f} rows/s; K22b launches per chunk "
          f"{launches['sink_ring'] / chunks:.2f}; port kernel launches "
          f"{sum(launches.values()) / chunks:.2f} per chunk", flush=True)
    if cuda:
        c0 = int(sink_state().cursor)
        n0 = kernels.LAUNCHES["sink_ring"]
        per_chunk = profile_window(torch, eng, query)
        print(f"[main] {query} launches per chunk "
              f"{'not measured' if per_chunk is None else f'{per_chunk:.1f}'}"
              f" (all CUDA kernels, profiled window)", flush=True)
        st = sink_state()
        k = kernels.LAUNCHES["sink_ring"] - n0
        us = sum(LAST_PROFILE.get(name, (0, 0))[0] for name in
                 ("sink_count_kernel", "sink_rank_kernel",
                  "sink_copy_kernel"))
        if k and us:
            rows = (int(st.cursor) - c0) / k
            b_ = sink_bound(rows, _sink_row_bytes(st))
            print(f"[main] {query} K22b {us / 1e3 / k:.4f} ms per launch "
                  f"(profiled, {rows:.0f} rows appended per launch), bound "
                  f"{b_[0]:.6f} ms; the plain version's time at q1_sink's "
                  "shape is the kernel phase's", flush=True)
    return launches, rate


def _deliver_line(query: str, log: list) -> None:
    ms = 1e3 * sum(log) / max(len(log), 1)
    print(f"[main] {query} deliver: {len(log)} snapshot barriers, host "
          f"{ms:.3f} ms per snapshot barrier (max "
          f"{1e3 * max(log, default=0):.3f} ms)", flush=True)


def _audit(eng) -> None:
    """Maintenance (counters read, loss raises) and a snapshot that
    delivers every sink's remaining rows."""
    eng.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1")
    eng.execute("ALTER SYSTEM SET snapshot_interval_checkpoints = 1")
    eng.tick(barriers=1, chunks_per_barrier=0)


def phase_q1_sink(torch, device, scale):
    """q1 into a blackhole sink at bench sizes (ring 2^23): K22b takes
    every bid; the ring read back once equals numpy's q1, all inserts."""
    import numpy as np

    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig

    cuda = device.type == "cuda"
    cfg = {k: v // scale for k, v in BENCH_CONFIG.items()}
    cfg["mv_ring_size"] = (1 << 23) // scale
    eng = Engine(PlannerConfig(**cfg), device=device)
    eng.execute(BENCH_SOURCES)
    eng.execute(Q1_SINK_SQL)
    entry = eng.catalog.get("q1_sink")
    ex, job = entry.mv_executor, entry.job
    delivers, snaps = [], []
    _time_deliver(ex, delivers)
    _count_snapshots(job, snaps)
    eng.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1000000")
    eng.execute("ALTER SYSTEM SET snapshot_interval_checkpoints = 8")
    eng.tick(barriers=WARMUP_BARRIERS if cuda else 1,
             chunks_per_barrier=CHUNKS_PER_BARRIER)
    cap = cfg["chunk_capacity"]
    launches, rate = _timed_window(
        torch, eng, device, "q1_sink", cap, BARRIERS if cuda else 2,
        lambda: job.states[-1])
    _audit(eng)
    _deliver_line("q1_sink", delivers)
    print("[main] q1_sink backfill: none (the sink reads the source)",
          flush=True)
    bids = _consumed_bids(eng, cap)
    st = job.states[-1]  # the sink is the fragment's last executor
    n = int(st.cursor)
    sink = ex.sink
    if n != bids["price"].shape[0] or sink.rows_written != n \
            or int(st.read_cursor) != n or int(st.overflow) != 0:
        fail(f"q1_sink: ring {n} rows (read {int(st.read_cursor)}, overflow "
             f"{int(st.overflow)}), blackhole {sink.rows_written} rows, "
             f"{bids['price'].shape[0]} bids consumed")
    if sink.commits != len(snaps):
        fail(f"q1_sink: {sink.commits} commits for {len(snaps)} snapshot "
             "barriers")
    price = np.round(np.float64(908_000) * (bids["price"] * 10**6).astype(
        np.float64) / 1e6).astype(np.int64)
    for name, col, want in (("auction", 0, bids["auction"]),
                            ("bidder", 1, bids["bidder"]),
                            ("price", 2, price), ("date_time", 3, bids["ts"])):
        if not np.array_equal(st.values[col][:n].cpu().numpy(), want):
            fail(f"q1_sink ring column {name} differs from numpy")
    if bool((st.ops[:n] != 0).any()):
        fail("q1_sink ring holds ops other than inserts")
    print(f"[check] q1_sink ring rows and ops equal numpy q1 over {n} bids "
          f"(all inserts); the blackhole counted {sink.rows_written} rows "
          f"in {sink.commits} commits = snapshot barriers; overflow 0",
          flush=True)
    del eng, job, st
    if cuda:
        torch.cuda.empty_cache()
    return launches, rate


def _threshold(counts) -> tuple[int, float]:
    """The least T with 0 < share(bids >= T) <= 1/2, and that share."""
    import numpy as np

    c = np.asarray(counts)
    for t in np.unique(c):
        share = float((c >= t).mean())
        if 0 < share <= 0.5:
            return int(t), share
    fail(f"q5 has no threshold keeping at most half of {len(c)} rows")


def _fold(lines) -> list[tuple]:
    seen = {}
    for rec in lines:
        key = (rec["auction"], rec["window_start"])
        if rec["op"] in ("insert", "update_insert"):
            seen[key] = rec["bids"]
        elif rec["op"] != "commit":
            seen.pop(key, None)
    return sorted((a, w, b) for (a, w), b in seen.items())


def _file_lines(path) -> list[dict]:
    with open(path) as f:
        return [json.loads(x) for x in f]


def _cascade_checks(eng, t: int, path: str, tag: str, cap: int):
    """q5 against numpy, q5_hot against q5's rows with bids >= T, the
    file's fold against q5_hot, one data line per ring row (none written
    twice, none lost); returns (file lines, q5 rows, q5_hot rows)."""
    job = eng.jobs[0]
    bids = _consumed_bids(eng, cap, job.sources["_src_q5"])
    msg = check_q5(eng, bids, "q5")
    q5 = sorted(tuple(int(x) for x in r) for r in eng.execute(
        "SELECT auction, window_start, bids FROM q5"))
    hot = sorted(tuple(int(x) for x in r) for r in eng.execute(
        "SELECT auction, window_start, bids FROM q5_hot"))
    if hot != [r for r in q5 if r[2] >= t]:
        fail(f"{tag}: q5_hot ({len(hot)} rows) is not q5's rows with bids "
             f">= {t}")
    lines = _file_lines(path)
    data = [x for x in lines if x["op"] != "commit"]
    entry = eng.catalog.get("q5_hot_sink")
    st = job.states[entry.dag_nodes[0]][-1]
    if len(data) != int(st.cursor) or int(st.read_cursor) != int(st.cursor) \
            or int(st.overflow) != 0:
        fail(f"{tag}: {len(data)} data lines for a sink cursor of "
             f"{int(st.cursor)} (read {int(st.read_cursor)}, overflow "
             f"{int(st.overflow)})")
    if _fold(data) != hot:
        fail(f"{tag}: the sink file's fold differs from q5_hot")
    print(f"[check] {tag} {msg}; q5_hot equals q5's {len(hot)} rows with "
          f"bids >= {t}; the file's {len(data)} data lines (one per ring "
          f"row: none twice, none lost) fold to q5_hot", flush=True)
    return lines, q5, hot


def phase_q5_cascade(torch, device, scale, durable: bool):
    """bench's q5, 4 barriers, then the cascade over its non-empty table
    (``q5_hot``, backfilled from q5's 2^18-slot snapshot) and a file sink
    over it; the rest of the warm-up, the timed barriers, the checks; the
    drops (store-less run) or a process death and a cold start (durable
    run)."""
    import gc
    import os
    import shutil
    import tempfile

    from risingwave_tpu_torch import kernels
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig
    from risingwave_tpu_torch.stream.dag import DagJob

    cuda = device.type == "cuda"
    tag = "q5_cascade durable" if durable else "q5_cascade"
    cfg = {k: v // scale for k, v in BENCH_CONFIG.items()}
    cfg["mv_ring_size"] = (1 << 21) // scale
    cap = cfg["chunk_capacity"]
    work = tempfile.mkdtemp(prefix="rw_cascade_")
    data_dir = os.path.join(work, "data") if durable else None
    path = os.path.join(work, "q5_hot.jsonl")
    info = {}
    try:
        eng = Engine(PlannerConfig(**cfg), data_dir=data_dir, device=device)
        eng.execute(BENCH_SOURCES)
        eng.execute(Q5_SQL)
        eng.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = "
                    "1000000")
        eng.execute("ALTER SYSTEM SET snapshot_interval_checkpoints = 8")
        eng.tick(barriers=Q5_BEFORE_CASCADE if cuda else 1,
                 chunks_per_barrier=CHUNKS_PER_BARRIER)
        t, share = _threshold([int(r[2]) for r in eng.execute(
            "SELECT auction, window_start, bids FROM q5")])
        n_q5 = len(eng.execute("SELECT auction FROM q5"))
        if cuda and share < 0.01:
            fail(f"{tag}: q5_hot would keep {100 * share:.2f}% of q5")
        backfills = []
        inner = DagJob.backfill_node

        def backfill(job, node_id, chunks, side=None):
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            inner(job, node_id, chunks, side)
            if cuda:
                torch.cuda.synchronize()
            backfills.append((chunks[0].capacity, time.perf_counter() - t0))

        DagJob.backfill_node = backfill
        kernels.reset_launches()
        try:
            eng.execute(
                "CREATE MATERIALIZED VIEW q5_hot AS SELECT auction, "
                f"window_start, bids FROM q5 WHERE bids >= {t};")
            eng.execute(f"CREATE SINK q5_hot_sink FROM q5_hot WITH "
                        f"(connector = 'file', path = '{path}');")
        finally:
            DagJob.backfill_node = inner
        bf_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        shown = (eng.execute("SHOW MATERIALIZED VIEWS"),
                 eng.execute("SHOW SINKS"))
        if shown != ([("q5",), ("q5_hot",)], [("q5_hot_sink",)]):
            fail(f"{tag}: SHOW after the cascade gave {shown}")
        print(f"[main] {tag} T = {t}: q5_hot keeps {100 * share:.2f}% of "
              f"q5's {n_q5} rows; backfills (chunk capacity, ms): "
              f"{[(c, round(1e3 * s, 3)) for c, s in backfills]}; their "
              f"launches {bf_launches}", flush=True)
        info.update(T=t, share=share, q5_rows=n_q5,
                    backfill_ms=[1e3 * s for _, s in backfills])
        if cuda and (bf_launches.get("sink_ring", 0) < 1
                     or bf_launches.get("mv_upsert", 0) < 1):
            fail(f"{tag}: the backfill did not launch K8 and K22b")
        job = eng.jobs[0]
        ex = eng.catalog.get("q5_hot_sink").mv_executor
        delivers, snaps = [], []
        _time_deliver(ex, delivers)
        _count_snapshots(job, snaps)
        eng.tick(barriers=(WARMUP_BARRIERS - Q5_BEFORE_CASCADE) if cuda
                 else 1, chunks_per_barrier=CHUNKS_PER_BARRIER)
        node = eng.catalog.get("q5_hot_sink").dag_nodes[0]
        launches, rate = _timed_window(
            torch, eng, device, tag, cap, BARRIERS if cuda else 2,
            lambda: job.states[node][-1])
        _audit(eng)
        _deliver_line(tag, delivers)
        lines, q5, hot = _cascade_checks(eng, t, path, tag, cap)
        commits = sum(x["op"] == "commit" for x in lines)
        if commits != len(delivers):
            fail(f"{tag}: {commits} commit records for {len(delivers)} "
                 "deliveries")
        if not durable:
            try:
                eng.execute("DROP MATERIALIZED VIEW q5")
                fail(f"{tag}: DROP MATERIALIZED VIEW q5 did not raise")
            except ValueError as e:
                refused = str(e)
            if eng.execute("SHOW MATERIALIZED VIEWS") != [("q5",),
                                                          ("q5_hot",)]:
                fail(f"{tag}: the refused DROP changed the catalog")
            eng.execute("DROP SINK q5_hot_sink")
            after_sink = eng.execute("SHOW SINKS")
            eng.execute("DROP MATERIALIZED VIEW q5_hot")
            shown = (after_sink, eng.execute("SHOW MATERIALIZED VIEWS"))
            if shown != ([], [("q5",)]) or job.nodes[1:] != [None, None]:
                fail(f"{tag}: after the drops SHOW gave {shown}")
            eng.tick(barriers=1, chunks_per_barrier=CHUNKS_PER_BARRIER)
            bids = _consumed_bids(eng, cap, job.sources["_src_q5"])
            msg = check_q5(eng, bids, "q5")
            print(f"[check] {tag} drops: DROP MATERIALIZED VIEW q5 refused "
                  f"({refused}); DROP SINK and DROP MATERIALIZED VIEW q5_hot "
                  f"left q5's node running; one more barrier: {msg}",
                  flush=True)
        else:
            names = sorted(e.name for e in eng.catalog.list())
            del eng, job, ex
            gc.collect()
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng = Engine(PlannerConfig(**cfg), data_dir=data_dir,
                         device=device)
            if cuda:
                torch.cuda.synchronize()
            info["recover_s"] = time.perf_counter() - t0
            got = sorted(e.name for e in eng.catalog.list())
            rows = [sorted(tuple(int(x) for x in r) for r in eng.execute(
                f"SELECT auction, window_start, bids FROM {m}"))
                for m in ("q5", "q5_hot")]
            if got != names or rows != [q5, hot]:
                fail(f"{tag}: the cold start gave catalog {got} (before "
                     f"{names}) and MVs equal to the pre-crash rows "
                     f"{[a == b for a, b in zip(rows, (q5, hot))]}")
            eng.tick(barriers=4 if cuda else 1,
                     chunks_per_barrier=CHUNKS_PER_BARRIER)
            _audit(eng)
            lines2, _, _ = _cascade_checks(eng, t, path, f"{tag} restarted",
                                           cap)
            if lines2[:len(lines)] != lines:
                fail(f"{tag}: the restarted sink rewrote the file's head")
            print(f"[cold start] {tag} {info['recover_s']:.3f} s: catalog "
                  f"{got}, q5 and q5_hot equal their pre-crash rows; 4 more "
                  f"barriers appended {len(lines2) - len(lines)} lines, "
                  "exactly once", flush=True)
        del eng
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if cuda:
        torch.cuda.empty_cache()
    return launches, rate, info


def phase_dedup_sink(torch, device, scale):
    """K19b's path, built by hand as ``tests/test_top_n.py`` builds the
    executor (no planner builds it): bids (100,000 events/s) -> q7's
    10 s TUMBLE -> ``AppendOnlyDedupExecutor`` on (window_start,
    auction), the closed windows evicted by the watermark (lag 10 s) ->
    a blackhole ``SinkExecutor`` (ring 2^21), at bench sizes with a
    maintenance pass every 8 checkpoints.  The ring must hold exactly
    the first bid of each (window, auction) pair."""
    import numpy as np

    from risingwave_tpu_torch.connector.sinks import BlackholeSink
    from risingwave_tpu_torch.expr.node import InputRef
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig
    from risingwave_tpu_torch.stream.executor import HopWindowExecutor
    from risingwave_tpu_torch.stream.fragment import Fragment
    from risingwave_tpu_torch.stream.runtime import StreamingJob
    from risingwave_tpu_torch.stream.sink import SinkExecutor
    from risingwave_tpu_torch.stream.top_n import AppendOnlyDedupExecutor
    from risingwave_tpu_torch.stream.watermark import WatermarkFilterExecutor

    cuda = device.type == "cuda"
    cfg = {k: v // scale for k, v in BENCH_CONFIG.items()}
    cap = cfg["chunk_capacity"]
    eng = Engine(PlannerConfig(**cfg), device=device)
    eng.execute(SLICE11_BID.format(rate=DEDUP_RATE))
    entry = eng.catalog.get("bid")
    schema = entry.schema
    ts = schema.index_of("date_time")
    hop = HopWindowExecutor(schema, ts, WINDOW_US, WINDOW_US)
    out = hop.out_schema
    dedup = AppendOnlyDedupExecutor(
        out, [InputRef(out.index_of("window_start")), InputRef(0)],
        table_size=DEDUP_TABLE // scale, watermark_key_idx=0,
        watermark_lag=WINDOW_US, watermark_src_col=ts)
    sink = SinkExecutor(out, BlackholeSink(), ring_size=(1 << 21) // scale)
    job = StreamingJob(entry.reader_factory(), Fragment(
        [WatermarkFilterExecutor(schema, *entry.watermark), hop, dedup,
         sink]), "dedup_sink", device=device)
    eng.jobs.append(job)
    # the sweeps are counted without a host read; the evicted keys are
    # the tombstones each rehash clears (read at maintenance) plus those
    # left at the end
    stats = {"sweeps": 0, "evicted": 0, "rehash": 0}
    on_wm, rehash = dedup.on_watermark, dedup.maybe_rehash

    def counted_wm(st, wm):
        stats["sweeps"] += wm.col_idx == ts
        return on_wm(st, wm)

    def counted_rehash(st):
        tomb = int(st.table.tombstone_count())
        new = rehash(st)
        if new is not st:
            stats["rehash"] += 1
            stats["evicted"] += tomb
        return new

    dedup.on_watermark, dedup.maybe_rehash = counted_wm, counted_rehash
    delivers = []
    _time_deliver(sink, delivers)
    eng.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 8")
    eng.execute("ALTER SYSTEM SET snapshot_interval_checkpoints = 8")
    eng.tick(barriers=WARMUP_BARRIERS if cuda else 1,
             chunks_per_barrier=CHUNKS_PER_BARRIER)
    launches, rate = _timed_window(
        torch, eng, device, "dedup_sink", cap, BARRIERS if cuda else 2,
        lambda: job.states[3])
    _audit(eng)
    _deliver_line("dedup_sink", delivers)
    print("[main] dedup_sink backfill: none (built on a fresh source)",
          flush=True)
    # numpy: the first bid of each (window, auction) pair, in stream order
    reader = job.source
    cols = {j: [] for j in (0, 1, 2, 5)}
    strs = {j: ([], []) for j in (3, 4)}
    for i in range(reader.offset // cap):
        c = reader.gen.gen_bids(i * cap, cap)
        for j in cols:
            cols[j].append(c.columns[j].cpu().numpy())
        for j in strs:
            strs[j][0].append(c.columns[j].data.cpu().numpy())
            strs[j][1].append(c.columns[j].lens.cpu().numpy())
    cols = {j: np.concatenate(v) for j, v in cols.items()}
    ws = cols[5] - cols[5] % WINDOW_US
    _, first = np.unique(np.stack([ws, cols[0]], 1), axis=0,
                         return_index=True)
    first = np.sort(first)
    stats["evicted"] += int(job.states[2].table.tombstone_count())
    st = job.states[3]
    n = int(st.cursor)
    if n != first.shape[0] or int(st.overflow) != 0 \
            or int(job.states[2].overflow) != 0:
        fail(f"dedup_sink: ring {n} rows for {first.shape[0]} first bids "
             f"(sink overflow {int(st.overflow)}, dedup overflow "
             f"{int(job.states[2].overflow)})")
    want = {0: cols[0][first], 1: cols[1][first], 2: cols[2][first],
            5: cols[5][first], 6: ws[first], 7: ws[first] + WINDOW_US}
    for j, w in want.items():
        if not np.array_equal(st.values[j][:n].cpu().numpy(), w):
            fail(f"dedup_sink ring column {out[j].name} differs from numpy")
    for j, (data, lens) in strs.items():
        if not (np.array_equal(st.values[j].data[:n].cpu().numpy(),
                               np.concatenate(data)[first])
                and np.array_equal(st.values[j].lens[:n].cpu().numpy(),
                                   np.concatenate(lens)[first])):
            fail(f"dedup_sink ring column {out[j].name} differs from numpy")
    if bool((st.ops[:n] != 0).any()) or sink.sink.rows_written != n:
        fail("dedup_sink: ops other than inserts, or the blackhole missed "
             "rows")
    if cuda and (stats["sweeps"] < 1 or stats["evicted"] < 1
                 or stats["rehash"] < 1):
        fail(f"dedup_sink: sweeps/evictions/rehashes {stats}")
    print(f"[check] dedup_sink ring holds exactly the first bid of each of "
          f"{n} (window, auction) pairs over {cols[0].shape[0]} bids, every "
          f"leaf equal to numpy; overflow 0", flush=True)
    print(f"[check] dedup_sink: the watermark's K4 sweep ran "
          f"{stats['sweeps']} times and evicted {stats['evicted']} keys; the "
          f"tombstone rehash fired {stats['rehash']} times", flush=True)
    del eng, job, st
    if cuda:
        torch.cuda.empty_cache()
    return launches, rate, stats


def run_sink_paths(torch, device, scale, results) -> dict:
    """The slice's four paths; their launches join the kernels line.
    Returns {path: (rows/s, info)}."""
    out = {}
    for path in SINK_PATHS:
        if path == "q1_sink":
            launches, rate = phase_q1_sink(torch, device, scale)
            info = {}
        elif path == "dedup_sink":
            launches, rate, info = phase_dedup_sink(torch, device, scale)
        else:
            launches, rate, info = phase_q5_cascade(
                torch, device, scale, durable=path.endswith("durable"))
        out[path] = (rate, info)
        for name, n in launches.items():
            if name in results:
                results[name]["launches"] += n
                results[name]["launches_by_query"][path] = n
        if path == "dedup_sink":
            d = results["append_only_dedup"]
            d["launches"] = launches["probe"]
            d["launches_by_query"][path] = {
                k: launches[k] for k in d["composed_of"]}
        missing = [k for k in SINK_PATH_KERNELS[path] if launches[k] <= 0]
        if device.type == "cuda" and missing:
            fail(f"{path}: kernels {missing} were not launched on the path")
    return out


# ---------------------------------------------------------------------------
# vnode-sharded aggregation: K2 (the vnode hash), K24 (the exchange), K22c
# (the partial aggregation) over a mesh of lanes on the card

#: lanes of the sharded engines (the parallelism that bench's q5 and q7 are
#: sharded over)
SHARD_LANES = 4
SHARD_QUERIES = ("q5", "q7")
SHARD_PATHS = ("q5 sharded", "q7 sharded", "q5 sharded durable",
               "q7 sharded durable")
#: the chain both queries plan as (the reference's, under parallelism 4)
SHARD_CHAIN = ["WatermarkFilterExecutor", "HopWindowExecutor",
               "PartialAggExecutor", "HashAggExecutor", "ProjectExecutor",
               "MaterializeExecutor"]
_SHARD_KERNELS = ("nexmark_bids", "hop_window", "hash64", "partial_agg",
                  "crc32", "exchange", "agg_preagg", "probe", "agg_scatter",
                  "mask_indices", "mv_upsert")
SHARD_PATH_KERNELS = {
    "q5 sharded": _SHARD_KERNELS,
    "q7 sharded": _SHARD_KERNELS,
    "q5 sharded durable": _SHARD_KERNELS + ("shadow_digest",),
    "q7 sharded durable": _SHARD_KERNELS + ("shadow_digest",),
}


def _shard_config(scale: int) -> dict:
    cfg = {k: v // scale for k, v in BENCH_CONFIG.items()}
    cfg["mv_ring_size"] = (1 << 21) // scale
    return cfg


def _sharded_engine(torch, device, cfg, query: str, data_dir=None):
    """bench's ``query`` under ``SET streaming_parallelism = 4`` on an
    engine of ``SHARD_LANES`` lanes (a cold start when ``data_dir`` holds
    a logged catalog)."""
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig
    from risingwave_tpu_torch.stream.sharded import ShardedStreamingJob

    eng = Engine(PlannerConfig(**cfg), data_dir=data_dir, device=device,
                 lanes=SHARD_LANES)
    if not eng.jobs:
        eng.execute(BENCH_SOURCES)
        eng.execute(f"SET streaming_parallelism = {SHARD_LANES}")
        eng.execute(QUERY_SQL[query])
        eng.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = "
                    "1000000")
        eng.execute("ALTER SYSTEM SET snapshot_interval_checkpoints = 8")
    job = eng.jobs[0]
    names = [type(e).__name__ for e in job.sharded.executors] \
        if isinstance(job, ShardedStreamingJob) else None
    if names != SHARD_CHAIN or job.sharded.n_shards != SHARD_LANES:
        fail(f"{query} sharded: planned {type(job).__name__} {names}")
    return eng


def _shard_planes(c):
    """Every plane of a chunk, in order (payloads, string bytes and
    lengths, NULL planes, ops, valid)."""
    from risingwave_tpu_torch.parallel.exchange import _chunk_leaves

    return [t for t, _ in _chunk_leaves(c)]


def _lane_partials(torch, eng):
    """One chunk round of the engine's sharded job through its local half
    on the card: every lane's partial aggregation input (the window's
    output) and its K22c arguments."""
    from risingwave_tpu_torch.common.chunk import conform_col
    from risingwave_tpu_torch.stream.partial_agg import sort_order

    job = eng.jobs[0]
    sj, lanes = job.sharded, job.lanes
    pa = sj.executors[sj.n_local - 1]
    out = []
    for s in range(sj.n_shards):
        chunk = sj.source_fn(job.reader.next_base(), sj.cap)
        for i, ex in enumerate(sj.executors[:sj.n_local - 1]):
            st, chunk = ex.apply(lanes.views[s][i], chunk)
        keys = [conform_col(e.eval(chunk), e.return_field(pa.in_schema)
                            .nullable, chunk.capacity)
                for _, e in pa.group_by]
        args = [None if a.arg is None else a.arg.eval(chunk)
                for a in pa.aggs]
        nk = len(pa.group_by)
        nullable = [pa.out_schema[nk + i].nullable
                    for i in range(len(pa.aggs))]
        out.append((pa, chunk, keys, args, [a.kind for a in pa.aggs],
                    nullable, sort_order(keys, chunk.valid)))
    return out


def _bits(torch, t):
    """A float tensor's bit pattern (NaN equals itself, -0.0 not +0.0)."""
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def _shard_edge_case(torch, device, cap: int, g):
    """A chunk of every key and argument kind K2 and K22c take, on the card
    and a CPU copy: int64 keys with duplicates, a nullable VARCHAR(8) with
    random bytes past the lengths, int32, int16, bool and float64 keys
    (NaN, -0.0, infinities, subnormals), nullable int64 / int32 / float64
    arguments, ops of all four kinds, 10% invalid rows."""
    from risingwave_tpu_torch.common.chunk import Chunk, NCol, StrCol
    from risingwave_tpu_torch.common.types import DataType, Field, Schema
    from risingwave_tpu_torch.stream.spill import chunk_to

    def f(name, t, nullable=False, w=None):
        kw = {"str_width": w} if w else {}
        return Field(name, t, nullable=nullable, **kw)

    schema = Schema((f("g", DataType.INT64), f("s", DataType.VARCHAR, True, 8),
                     f("h", DataType.INT32), f("t", DataType.INT16),
                     f("b", DataType.BOOLEAN), f("k", DataType.FLOAT64),
                     f("v", DataType.INT64, True), f("i", DataType.INT32, True),
                     f("x", DataType.FLOAT64, True)))
    grp = torch.randint(0, 50, (cap,), generator=g)
    sb = torch.randint(0, 256, (cap, 8), generator=g, dtype=torch.uint8)
    sb[:, :2] = (grp[:, None] % 5 + 65).to(torch.uint8)
    sl = torch.randint(0, 3, (cap,), generator=g, dtype=torch.int32)
    edge = torch.tensor([0.5, -0.0, 0.0, float("nan"), float("inf"),
                         float("-inf"), 5e-324, 2.0], dtype=torch.float64)

    def nulls(p):
        return torch.rand(cap, generator=g) < p

    cols = [grp.to(torch.int64), NCol(StrCol(sb, sl), nulls(0.2)),
            (grp * 7 - 3).to(torch.int32), (grp - 20).to(torch.int16),
            grp % 2 == 0, edge[grp % 8],
            NCol(torch.randint(-2**40, 2**40, (cap,), generator=g), nulls(0.3)),
            NCol(torch.randint(-2**31, 2**31 - 1, (cap,), generator=g,
                               dtype=torch.int32), nulls(0.5)),
            NCol(torch.randn(cap, generator=g, dtype=torch.float64) * 100,
                 nulls(0.3))]
    ops = torch.randint(0, 4, (cap,), generator=g, dtype=torch.int8)
    chunk = Chunk(cols, ops, torch.rand(cap, generator=g) < 0.9, schema)
    return schema, chunk_to(chunk, device), chunk


def _phase_shard_edges(torch, device, cap: int) -> None:
    """K22c, K2 and K24 on ``_shard_edge_case`` chunks, the card against
    the plain versions on a CPU copy: every plane exact except the float64
    sums (within 1e-12 relative: the plain version's ``index_add_``)."""
    import zlib

    from risingwave_tpu_torch.common.hash import compute_vnodes, crc32_columns
    from risingwave_tpu_torch.expr.agg import AggCall
    from risingwave_tpu_torch.expr.node import InputRef
    from risingwave_tpu_torch.parallel.exchange import shuffle_chunk
    from risingwave_tpu_torch.stream.partial_agg import PartialAggExecutor
    from risingwave_tpu_torch.stream.spill import chunk_to

    g = torch.Generator(device="cpu").manual_seed(14)
    cases = {"int64": (0,), "string": (1,), "int32+int16+bool": (2, 3, 4),
             "float64": (5,)}
    aggs = [("count_star", None), ("count", 6), ("sum", 6), ("sum", 7),
            ("min", 6), ("max", 7), ("sum0", 8), ("sum", 8), ("min", 8),
            ("max", 8), ("count", 8)]
    cpu = torch.device("cpu")
    for name, keys in cases.items():
        lanes_card, lanes_cpu = [], []
        for lane in range(SHARD_LANES):
            schema, card, host = _shard_edge_case(torch, device, cap, g)
            ex = PartialAggExecutor(
                schema, [(schema[i].name, InputRef(i)) for i in keys],
                [AggCall(k, None if a is None else InputRef(a), f"a{n}")
                 for n, (k, a) in enumerate(aggs)])
            _, out = ex.apply((), card)
            _, want = ex.apply((), host)
            pairs = []
            for ci, (ca, cb) in enumerate(zip(out.columns, want.columns)):
                float_sum = ci >= len(keys) and aggs[ci - len(keys)] in (
                    ("sum0", 8), ("sum", 8))
                for k, (a, b) in enumerate(zip(_col_planes("", ca),
                                               _col_planes("", cb))):
                    a, b = a[1].cpu(), b[1]
                    if float_sum and k == 0:
                        if not bool(torch.isclose(a, b, rtol=1e-12,
                                                  atol=1e-9).all()):
                            fail(f"K22c {name} edge float sum {ci} differs")
                        continue
                    pairs.append((f"K22c {name} edge column {ci} plane {k}",
                                  _bits(torch, a), _bits(torch, b)))
            pairs += [(f"K22c {name} edge ops", out.ops.cpu(), want.ops),
                      (f"K22c {name} edge valid", out.valid.cpu(),
                       want.valid)]
            max_abs_err(torch, pairs)
            vn = compute_vnodes([out.column(i) for i in range(len(keys))])
            want_vn = compute_vnodes([want.column(i)
                                      for i in range(len(keys))])
            max_abs_err(torch, [(f"K2 {name} edge", vn.cpu(), want_vn)])
            if name == "int64" and lane == 0:
                # K2's CRC is zlib's over the key's little-endian bytes
                crc = crc32_columns([out.column(0)]).cpu().tolist()
                keys64 = out.column(0).cpu().tolist()
                if crc != [zlib.crc32(k.to_bytes(8, "little", signed=True))
                           for k in keys64]:
                    fail("K2's CRC differs from zlib.crc32")
            lanes_card.append(out)
            lanes_cpu.append(chunk_to(out, cpu))
        got = shuffle_chunk(lanes_card, [[c.column(i) for i in
                                          range(len(keys))]
                                         for c in lanes_card])
        want = shuffle_chunk(lanes_cpu, [[c.column(i) for i in
                                          range(len(keys))]
                                         for c in lanes_cpu])
        max_abs_err(torch, [
            (f"K24 {name} edge lane {d} plane {k}", _bits(torch, a.cpu()),
             _bits(torch, b))
            for d, (cg, cw) in enumerate(zip(got, want))
            for k, (a, b) in enumerate(zip(_shard_planes(cg),
                                           _shard_planes(cw)))])
    print(f"[partial_agg] [crc32] [exchange] exact on edge cases ({cap}-row "
          "chunks, 4 lanes; int64, nullable VARCHAR with bytes past the "
          "lengths, int32+int16+bool and float64 keys with NaN, -0.0, "
          "infinities and a subnormal; every two-phase kind over nullable "
          "int64, int32 and float64 with retractions and invalid rows; "
          "float64 sums within 1e-12 relative) against the plain versions "
          "on a CPU copy; K2's CRC equals zlib.crc32 of the int64 keys",
          flush=True)


def phase_shard_kernels(torch, device, timer, scale):
    """K22c, K2 and K24 against their plain versions on the same card
    tensors, exactly, at the main paths' shapes: one chunk round (8192
    bids a lane, 4 lanes) of bench's q5 (HOP: 40,960 rows a lane keyed
    (auction, window_start)) and q7 (TUMBLE: 8192 rows a lane keyed
    window_start, one window) through the local half of a sharded engine;
    K22c on every lane's window output (every output plane of every row),
    K2 on every lane's partial rows (vnodes, and the CRC against
    ``crc32_columns_plain``), K24 over the 4 lanes (every plane of every
    lane's received chunk, the fills included).  Timed at q5's shape
    (K24 also at q7's, its skew: every row for one lane)."""
    from risingwave_tpu_torch.common.chunk import Chunk
    from risingwave_tpu_torch.common.hash import (
        compute_vnodes_cuda,
        compute_vnodes_plain,
        crc32_columns_plain,
        normalize_null_col,
    )
    from risingwave_tpu_torch.parallel.exchange import (
        shuffle_chunk_cuda,
        shuffle_chunk_plain,
    )
    from risingwave_tpu_torch.stream.partial_agg import (
        partial_agg,
        partial_agg_plain,
    )

    cuda = device.type == "cuda"
    cfg = _shard_config(scale)
    res = {}
    timing = {}
    _phase_shard_edges(torch, device, 8192 // scale)
    for query in SHARD_QUERIES:
        eng = _sharded_engine(torch, device, cfg, query)
        lanes = _lane_partials(torch, eng)
        sj = eng.jobs[0].sharded
        pa_out, vnodes = [], []
        pairs, n_rows, n_valid = [], 0, 0
        for s, (pa, chunk, keys, args, kinds, nullable, order) in \
                enumerate(lanes):
            got = partial_agg(keys, args, kinds, nullable, chunk.valid,
                              chunk.signs(), order)
            want = partial_agg_plain(keys, args, kinds, nullable,
                                     chunk.valid, chunk.signs(), order)
            ops = torch.zeros(chunk.capacity, dtype=torch.int8,
                              device=device)
            c_got = Chunk(tuple(got[0]) + tuple(got[1]), ops, got[2],
                          pa.out_schema)
            c_want = Chunk(tuple(want[0]) + tuple(want[1]), ops, want[2],
                           pa.out_schema)
            pairs += [(f"K22c {query} lane {s} plane {k}", a, b)
                      for k, (a, b) in enumerate(zip(_shard_planes(c_got),
                                                     _shard_planes(c_want)))]
            pa_out.append(c_got)
            n_rows += chunk.capacity
            n_valid += int(c_got.valid.sum())
        max_abs_err(torch, pairs)
        print(f"[partial_agg] exact on {query}'s {SHARD_LANES} lanes "
              f"({n_rows} window rows into {n_valid} partial rows: every "
              "plane of every row)", flush=True)
        pairs = []
        for s, c in enumerate(pa_out):
            keys = sj.exchange_key_fn(c)
            if cuda:
                vn, crc = compute_vnodes_cuda(keys, with_crc=True)
            else:
                vn = compute_vnodes_plain(keys)
                crc = crc32_columns_plain(
                    [x for k in keys for x in normalize_null_col(k)])
            flat = [x for k in keys for x in normalize_null_col(k)]
            pairs += [(f"K2 {query} lane {s} vnodes", vn,
                       compute_vnodes_plain(keys)),
                      (f"K2 {query} lane {s} crc", crc,
                       crc32_columns_plain(flat))]
            vnodes.append(vn)
        max_abs_err(torch, pairs)
        got = shuffle_chunk_cuda(pa_out, vnodes) if cuda else \
            shuffle_chunk_plain(pa_out, vnodes)
        want = shuffle_chunk_plain(pa_out, vnodes)
        max_abs_err(torch, [
            (f"K24 {query} lane {d} plane {k}", a, b)
            for d, (cg, cw) in enumerate(zip(got, want))
            for k, (a, b) in enumerate(zip(_shard_planes(cg),
                                           _shard_planes(cw)))])
        per_lane = [int(c.valid.sum()) for c in got]
        print(f"[crc32] exact on {query}'s partial rows ({SHARD_LANES} "
              f"lanes); [exchange] exact on every plane of every lane, rows "
              f"received per lane {per_lane}", flush=True)
        timing[query] = (lanes, pa_out, vnodes, per_lane)
        del eng
    # -- times at q5's shape (lane 0), K24 at both ----------------------
    lanes, pa_out, vnodes, _ = timing["q5"]
    pa, chunk, keys, args, kinds, nullable, order = lanes[0]
    signs = chunk.signs()
    ms = timer(lambda i: partial_agg(keys, args, kinds, nullable,
                                     chunk.valid, signs, order), 100)
    plain_ms = timer(lambda i: partial_agg_plain(keys, args, kinds, nullable,
                                                 chunk.valid, signs, order),
                     20)
    cap = chunk.capacity
    key_b = sum(row_bytes(k) for k in keys)
    arg_b = sum(row_bytes(a) for a in args if a is not None)
    part_b = sum(row_bytes(p) for p in pa_out[0].columns[len(keys):])
    # every row: keys, arguments, its perm entry, sign and valid read; its
    # sorted key, partials and valid written
    b = bound(cap * (key_b + arg_b + 8 + 4 + 1) + cap * (key_b + part_b + 1),
              cap * 8 * len(kinds))
    print(f"[partial_agg] q5 lane chunk of {cap} rows: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {b[0]:.6f} ms ({b[1]}); the sort "
          "and kernel A before it are not in these times", flush=True)
    res["partial_agg"] = kernel_entry(
        "partial_agg.cu", "risingwave_tpu/stream/partial_agg.py:103", ms,
        plain_ms, b, None, 0.0)
    c0 = pa_out[0]
    kc = [c0.column(i) for i in range(len(keys))]
    ms = timer(lambda i: (compute_vnodes_cuda(kc) if cuda else
                          compute_vnodes_plain(kc)), 200)
    plain_ms = timer(lambda i: compute_vnodes_plain(kc), 20)
    act = int(c0.valid.sum())
    kb = sum(row_bytes(k) for k in kc)
    # the valid rows' key bytes read and vnodes written; ~5 integer ops a
    # key byte (shift, xor, mask, table read, xor)
    b = bound(act * (kb + 4), act * kb * 5)
    print(f"[crc32] q5 lane chunk ({cap} rows, {act} valid): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b[0]:.6f} ms "
          f"({b[1]}, valid rows)", flush=True)
    res["crc32"] = kernel_entry(
        "crc32.cu", "risingwave_tpu/common/hash.py:94", ms, plain_ms, b,
        None, 0.0)
    out = {}
    for query in SHARD_QUERIES:
        _, pa_out, vnodes, per_lane = timing[query]
        ms = timer(lambda i: (shuffle_chunk_cuda(pa_out, vnodes) if cuda
                              else shuffle_chunk_plain(pa_out, vnodes)), 100)
        plain_ms = timer(lambda i: shuffle_chunk_plain(pa_out, vnodes), 20)
        n, cap = len(pa_out), pa_out[0].capacity
        row_b = sum(row_bytes(t) for t in _shard_planes(pa_out[0]))
        sent = sum(per_lane)
        # the sent rows' planes, and every row's vnode and valid byte read;
        # every slot of every lane's received chunk written once
        b = bound(sent * row_b + n * cap * 5 + n * n * cap * row_b, 0)
        print(f"[exchange] {query}: {n} lanes x {cap} rows, {sent} sent: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b[0]:.6f} ms ({b[1]})", flush=True)
        out[query] = (ms, plain_ms, b)
    ms, plain_ms, b = out["q5"]
    res["exchange"] = kernel_entry(
        "exchange.cu", "risingwave_tpu/parallel/exchange.py:124", ms,
        plain_ms, b, None, 0.0)
    res["exchange"]["q7"] = {"ms": out["q7"][0], "plain_ms": out["q7"][1],
                             "bound_ms": out["q7"][2][0]}
    del timing, lanes, pa_out
    if cuda:
        torch.cuda.empty_cache()
    return res


def _equal_states(torch, tag: str, a, b) -> None:
    from risingwave_tpu_torch.common.tree import flatten

    la, lb = flatten(a)[0], flatten(b)[0]
    if len(la) != len(lb):
        fail(f"{tag}: {len(la)} state leaves against {len(lb)}")
    max_abs_err(torch, [(f"{tag} leaf {i}", x, y)
                        for i, (x, y) in enumerate(zip(la, lb))])


def phase_sharded_main_path(torch, device, scale, query: str):
    """bench's ``query`` sharded over 4 lanes through SQL at bench.py's
    sizes: 9 warm-up and 32 timed barriers of 8 chunk rounds (4 x 8192
    bids a round) with the launch counters, a profiled window, the audit;
    the MV against numpy over the consumed bids and against the port's
    linear run over the same bids."""
    from risingwave_tpu_torch import kernels
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig

    cuda = device.type == "cuda"
    cfg = _shard_config(scale)
    cap = cfg["chunk_capacity"]
    eng = _sharded_engine(torch, device, cfg, query)
    eng.tick(barriers=WARMUP_BARRIERS if cuda else 1,
             chunks_per_barrier=CHUNKS_PER_BARRIER)
    if cuda:
        torch.cuda.synchronize()
    kernels.reset_launches()
    barriers = BARRIERS if cuda else 2
    t0 = time.perf_counter()
    eng.tick(barriers=barriers, chunks_per_barrier=CHUNKS_PER_BARRIER)
    if cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    rounds = barriers * CHUNKS_PER_BARRIER
    rows = rounds * SHARD_LANES * cap
    rate = rows / dt
    per = {k: launches[k] / rounds for k in ("crc32", "exchange",
                                             "partial_agg")}
    print(f"[main] {query} sharded {rows} rows in {dt:.3f} s = {rate:.0f} "
          f"rows/s on {SHARD_LANES} lanes; launches per chunk round "
          f"{per}; port kernel launches "
          f"{sum(launches.values()) / rounds:.1f} per round", flush=True)
    if cuda:
        per_round = profile_window(torch, eng, f"{query} sharded")
        print(f"[main] {query} sharded launches per chunk round "
              f"{'not measured' if per_round is None else f'{per_round:.1f}'}"
              " (all CUDA kernels, profiled window)", flush=True)
    eng.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1")
    eng.tick(barriers=1, chunks_per_barrier=0)
    bids = _consumed_bids(eng, cap)
    msg = {"q5": check_q5, "q7": check_q7}[query](eng, bids)
    print(f"[check] {query} sharded {msg}", flush=True)
    # the port's linear run over the same bids, its tables as large as
    # the lanes' together; its audit raises on any loss
    total = eng.jobs[0].reader.offset // cap
    lin_cfg = dict(cfg, agg_table_size=cfg["agg_table_size"] * SHARD_LANES,
                   mv_table_size=cfg["mv_table_size"] * SHARD_LANES)
    lin = Engine(PlannerConfig(**lin_cfg), device=device)
    lin.execute(BENCH_SOURCES)
    lin.execute(QUERY_SQL[query])
    lin.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1000000")
    per_b = CHUNKS_PER_BARRIER * SHARD_LANES
    lin.tick(barriers=total // per_b, chunks_per_barrier=per_b)
    lin.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1")
    lin.tick(barriers=1, chunks_per_barrier=total % per_b)
    if lin.jobs[0].source.offset != eng.jobs[0].reader.offset:
        fail(f"{query}: the linear run consumed {lin.jobs[0].source.offset} "
             f"bids, the sharded {eng.jobs[0].reader.offset}")
    a = sorted(eng.execute("SELECT * FROM bench_mv"))
    b = sorted(lin.execute("SELECT * FROM bench_mv"))
    if a != b:
        fail(f"{query} sharded MV ({len(a)} rows) differs from the linear "
             f"run's ({len(b)} rows)")
    print(f"[check] {query} sharded MV equals the port's linear run over "
          f"the same {eng.jobs[0].reader.offset} bids ({len(a)} rows)",
          flush=True)
    del eng, lin
    if cuda:
        torch.cuda.empty_cache()
    return launches, rate


def phase_sharded_durable(torch, device, scale, query: str):
    """The sharded ``query`` durably (``data_dir``): 8 timed barriers, a
    snapshot at the 8th (K11 over the stacked lanes, the uploader), then a
    cold start from the directory whose every state tensor equals the
    engine's that never stopped, and 2 more barriers on both, equal again
    with equal MV rows."""
    import gc
    import shutil
    import tempfile

    from risingwave_tpu_torch import kernels

    cuda = device.type == "cuda"
    cfg = _shard_config(scale)
    cap = cfg["chunk_capacity"]
    per = CHUNKS_PER_BARRIER if cuda else 2
    data_dir = tempfile.mkdtemp(prefix=f"rw_sharded_{query}_")
    try:
        eng = _sharded_engine(torch, device, cfg, query, data_dir)
        if cuda:
            torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        eng.tick(barriers=8, chunks_per_barrier=per)
        if cuda:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        job, store = eng.jobs[0], eng.checkpoint_store
        rate = 8 * per * SHARD_LANES * cap / dt
        commits = list(store.commits)
        print(f"[durable] {query} sharded {8 * per * SHARD_LANES * cap} rows "
              f"in {dt:.3f} s = {rate:.0f} rows/s (the first 8 barriers, "
              f"one snapshot); committed epoch {job.committed_epoch} = "
              f"sealed {job.sealed_epoch}; commits "
              f"{[(c[2], c[3]) for c in commits]}", flush=True)
        if job.committed_epoch != job.sealed_epoch or not commits:
            fail(f"{query} sharded: nothing committed")
        t0 = time.perf_counter()
        eng2 = _sharded_engine(torch, device, cfg, query, data_dir)
        if cuda:
            torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
        _equal_states(torch, f"{query} sharded cold start", eng2.jobs[0].states,
                      job.states)
        if eng2.jobs[0].reader.offset != job.reader.offset:
            fail(f"{query} sharded cold start: reader offset differs")
        for e in (eng, eng2):
            e.tick(barriers=2, chunks_per_barrier=per)
        _equal_states(torch, f"{query} sharded after the cold start",
                      eng2.jobs[0].states, eng.jobs[0].states)
        if sorted(eng.execute("SELECT * FROM bench_mv")) != \
                sorted(eng2.execute("SELECT * FROM bench_mv")):
            fail(f"{query} sharded: MV rows differ after the cold start")
        print(f"[cold start] {query} sharded recovered the 4 lanes' epoch in "
              f"{rec_s:.3f} s; every state tensor equals the engine that "
              "never stopped, before and after 2 more barriers", flush=True)
        del eng, eng2, job
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        return launches, rate, {"recover_s": rec_s}
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)


def run_sharded_paths(torch, device, scale, results) -> dict:
    """The slice's four paths; their launches join the kernels line.
    Returns {path: (rows/s, info)}."""
    out = {}
    for path in SHARD_PATHS:
        query = path.split()[0]
        if path.endswith("durable"):
            launches, rate, info = phase_sharded_durable(torch, device, scale,
                                                         query)
        else:
            launches, rate = phase_sharded_main_path(torch, device, scale,
                                                     query)
            info = {}
        out[path] = (rate, info)
        for name, n in launches.items():
            if name in results:
                results[name]["launches"] += n
                results[name]["launches_by_query"][path] = n
        missing = [k for k in SHARD_PATH_KERNELS[path] if launches[k] <= 0]
        if device.type == "cuda" and missing:
            fail(f"{path}: kernels {missing} were not launched on the path")
    return out


# ---------------------------------------------------------------------------
# 9. the vnode-sharded join DAG: bench's q8 over 4 lanes


Q8_SHARD_PATHS = ("q8 sharded", "q8 sharded durable")
#: the reference's node chain for q8 under parallelism 4
Q8_SHARD_NODES = [
    ("FragNode", ["WatermarkFilterExecutor", "HopWindowExecutor"]),
    ("FragNode", ["WatermarkFilterExecutor", "HopWindowExecutor"]),
    ("JoinNode", None),
    ("FragNode", ["ProjectExecutor", "AppendOnlyMaterialize"])]
#: q8's kernels (the rehash passes' K4 aside: they fire by the state's
#: tombstones, not in every window) and the exchange on both join inputs
_Q8_SHARD_KERNELS = tuple(k for k in PATH_KERNELS["q8"]
                          if k != "permute_rows") + ("crc32", "exchange")
Q8_SHARD_PATH_KERNELS = {
    "q8 sharded": _Q8_SHARD_KERNELS,
    "q8 sharded durable": _Q8_SHARD_KERNELS + ("shadow_digest_lanes",),
}
#: timed barriers of the q8 sharded paths (each 8 rounds x 4 lanes)
Q8_SHARD_BARRIERS = 8


def _q8_shard_config(scale: int) -> dict:
    """bench.py's q8 sizes for each lane (``_q8_engine``'s)."""
    cfg = {k: max(v // scale, 64) for k, v in Q8_CONFIG.items()}
    if scale > 1:
        # the rehearsal's pools and rings hold every row of its run
        cfg.update(join_pool_size=1 << 14, mv_ring_size=1 << 15)
    return cfg


def _q8_sharded_engine(torch, device, cfg, data_dir=None,
                       snapshot: int = 8):
    """bench's q8 under ``SET streaming_parallelism = 4`` on an engine of
    ``SHARD_LANES`` lanes (a cold start when ``data_dir`` holds a logged
    catalog); fails unless it plans as the reference's lane ``DagJob``."""
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig
    from risingwave_tpu_torch.stream.dag import DagJob

    eng = Engine(PlannerConfig(**cfg), data_dir=data_dir, device=device,
                 lanes=SHARD_LANES)
    if not eng.jobs:
        eng.execute(BENCH_SOURCES)
        eng.execute(f"SET streaming_parallelism = {SHARD_LANES}")
        eng.execute(QUERY_SQL["q8"])
        eng.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = "
                    "1000000")
        eng.execute(f"ALTER SYSTEM SET snapshot_interval_checkpoints = "
                    f"{snapshot}")
    job = eng.jobs[0]
    nodes = [(type(n).__name__,
              [type(e).__name__ for e in n.fragment.executors]
              if hasattr(n, "fragment") else None) for n in job.nodes] \
        if isinstance(job, DagJob) else None
    if nodes != Q8_SHARD_NODES or job.n_shards != SHARD_LANES or \
            sorted(job.exchanges) != [(2, "left"), (2, "right")]:
        fail(f"q8 sharded: planned {type(job).__name__} {nodes}")
    return eng


def _loss_counters(eng) -> dict:
    """The job's counters (summed over a DagJob's lanes), read once."""
    job = eng.jobs[0]
    labels = job.counter_labels if hasattr(job, "counter_labels") \
        else job.fragment.counter_labels
    vals = job._counters.cpu().tolist()
    return {k: v for k, v in zip(labels, vals) if not k.endswith(".pending")}


def phase_k11_lanes(torch, device, timer, scale):
    """K11 lanes (the shadow update and the delta's dirty gather over the
    lane grid) on the stacked state tree of a bench-size q8 engine sharded
    over 4 lanes, after 10 barriers: the init, two more barriers of
    traffic, the update at the dirty share they leave and the gather of
    those blocks, each against its plain version on the same card
    tensors, exactly (digests, dirty count, every shadow leaf, the
    staging bytes and the runs cut from them)."""
    import numpy as np

    from risingwave_tpu_torch.common.tree import flatten
    from risingwave_tpu_torch.storage import digest as dg
    from risingwave_tpu_torch.stream.shadow import leaf_lanes

    cuda = device.type == "cuda"
    eng = _q8_sharded_engine(torch, device, _q8_shard_config(scale))
    eng.tick(barriers=10 if cuda else 1,
             chunks_per_barrier=CHUNKS_PER_BARRIER if cuda else 1)
    job = eng.jobs[0]
    block = dg.DEFAULT_BLOCK_ELEMS
    tree = flatten(job.states)[0]
    shapes = [tuple(x.shape) for x in tree]
    grid = [leaf_lanes(sh, SHARD_LANES) for sh in shapes]
    rows = [g[0] if g else 1 for g in grid]
    nblocks = dg.block_counts(shapes, grid, block)
    total = sum(nblocks)

    def flat_leaves():
        return [x.reshape(-1) for x in flatten(job.states)[0]]

    leaves = flat_leaves()
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    words = sum(nb * block * x.element_size() // 8
                for x, nb in zip(leaves, nblocks))

    def buffers():
        return ([torch.empty_like(x) for x in leaves],
                torch.zeros(total, dtype=torch.int64, device=device),
                torch.zeros((), dtype=torch.int64, device=device))

    shk, dgk, dck = buffers()
    shp, dgp, dcp = buffers()
    dg.shadow_digest(leaves, shk, dgk, dck, nblocks, block, update=False,
                     rows=rows)
    dg.shadow_digest_plain(leaves, shp, dgp, dcp, nblocks, block,
                           update=False, rows=rows)
    pairs = [("lanes init digests", dgk, dgp)]
    pairs += [(f"lanes init shadow leaf {i}", a, b)
              for i, (a, b) in enumerate(zip(shk, shp))]
    max_abs_err(torch, pairs)
    eng.tick(barriers=2, chunks_per_barrier=CHUNKS_PER_BARRIER if cuda
             else 1)
    leaves = flat_leaves()
    old = dgk.clone()
    dg.shadow_digest(leaves, shk, dgk, dck, nblocks, block, update=True,
                     rows=rows)
    dg.shadow_digest_plain(leaves, shp, dgp, dcp, nblocks, block,
                           update=True, rows=rows)
    pairs = [("lanes update digests", dgk, dgp),
             ("lanes update dirty", dck, dcp)]
    pairs += [(f"lanes update shadow leaf {i}", a, b)
              for i, (a, b) in enumerate(zip(shk, shp))]
    pairs += [(f"lanes shadow equals live leaf {i}", a, b)
              for i, (a, b) in enumerate(zip(shk, leaves))]
    err = max_abs_err(torch, pairs)
    dirty = (dgk != old).cpu().numpy()
    n_dirty, ladder_dirty = int(dirty.sum()), int(dck)
    dirty_bytes = sum(
        int(dirty[o:o + nb].sum()) * block * x.element_size()
        for x, nb, o in zip(leaves, nblocks,
                            np.cumsum([0] + nblocks[:-1])))

    def update(i):
        dgk.copy_(old)  # every call diffs against the same old digests
        dg.shadow_digest(leaves, shk, dgk, dck, nblocks, block, update=True,
                         rows=rows)

    ms = timer(update, 10)

    def update_plain(i):
        dgp.copy_(old)
        dg.shadow_digest_plain(leaves, shp, dgp, dcp, nblocks, block,
                               update=True, rows=rows)

    plain_ms = timer(update_plain, 1)
    # as K11: every live byte read once, the dirty blocks and the digests
    # written; ~21 integer ops per 8-byte word
    b = bound(nbytes + dirty_bytes + 16 * total, words * 21)
    lane_leaves = sum(g is not None for g in grid)
    print(f"[shadow_digest_lanes] exact (q8 sharded state: {len(leaves)} "
          f"leaves, {lane_leaves} on the {SHARD_LANES}-lane grid, "
          f"{nbytes / 1e6:.1f} MB, {total} blocks; after 2 barriers "
          f"{n_dirty} blocks dirty ({100 * n_dirty / total:.1f}%), "
          f"{ladder_dirty} counted); update kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b[0]:.5f} ms ({b[1]})", flush=True)
    out = {"shadow_digest_lanes": kernel_entry(
        "shadow_digest.cu", "risingwave_tpu/stream/shadow.py:122", ms,
        plain_ms, b, None, err)}
    out["shadow_digest_lanes"].update(state_bytes=nbytes, blocks=total,
                                      dirty_blocks=n_dirty)

    # -- the lane delta's dirty gather -----------------------------------
    sizes = [x.numel() for x in leaves]
    esizes = [x.element_size() for x in leaves]
    entries, runs, gtotal = dg.gather_plan(dirty, nblocks, sizes, esizes,
                                           block, rows)
    ent = torch.from_numpy(entries).to(device)
    stk = torch.zeros(max(gtotal, 1), dtype=torch.uint8, device=device)
    stp = torch.zeros(max(gtotal, 1), dtype=torch.uint8, device=device)
    dg.dirty_gather(shk, ent, stk, nblocks, block, rows)
    dg.dirty_gather_plain(shk, ent, stp, block, rows)
    host = stk.cpu().numpy()
    for li, s0, e0, o in runs[:64] + runs[-64:]:
        want = shk[li][s0:e0].cpu().numpy().view(np.uint8)
        if not np.array_equal(host[o:o + want.size], want):
            fail(f"lane gather run r_{li}_{s0} differs from the shadow")
    crossing = sum((s0 // (sizes[li] // rows[li]))
                   != ((e0 - 1) // (sizes[li] // rows[li]))
                   for li, s0, e0, _ in runs if e0 > s0)
    if crossing:
        fail(f"{crossing} lane runs cross a lane row")
    err = max_abs_err(torch, [("lanes gather staging", stk, stp)])
    gms = timer(lambda i: dg.dirty_gather(shk, ent, stk, nblocks, block,
                                          rows), 20)
    gplain_ms = timer(lambda i: dg.dirty_gather_plain(shk, ent, stp, block,
                                                      rows), 2)
    gb = bound(2 * gtotal + entries.nbytes, len(entries) * 8)
    # one index_select over the block view of the exact-grid lane leaf
    # with the most dirty blocks computes that leaf's share
    e_leaf = entries[:, 0] >> 32
    exact = np.array([grid[int(li)] is not None
                      and (sizes[int(li)] // rows[int(li)]) % block == 0
                      for li in e_leaf], bool)
    lib = None
    if exact.any():
        li = int(np.bincount(e_leaf[exact], minlength=len(leaves)).argmax())
        sel = exact & (e_leaf == li)
        x = shk[li]
        view = x.view(-1, block)
        idx = torch.from_numpy((entries[sel, 0] & 0xFFFFFFFF)
                               .astype(np.int64)).to(device)
        o = int(entries[sel][0, 1])
        if not torch.equal(torch.index_select(view, 0, idx).reshape(-1)
                           .view(torch.uint8),
                           stk[o:o + int(sel.sum()) * block
                               * x.element_size()]):
            fail("index_select over the lane leaf's blocks differs from "
                 "the gather's section of it")
        lib = {"ms": timer(lambda i: torch.index_select(view, 0, idx), 20),
               "blocks": int(sel.sum()), "of": len(entries)}
    print(f"[dirty_gather_lanes] exact ({len(entries)} blocks in "
          f"{len(runs)} runs, none across a lane row, {gtotal / 1e6:.1f} "
          f"MB); kernel {gms:.4f} ms, plain {gplain_ms:.4f} ms, bound "
          f"{gb[0]:.5f} ms; one index_select over one lane leaf "
          f"{'not measured' if lib is None else lib}", flush=True)
    out["dirty_gather_lanes"] = kernel_entry(
        "shadow_digest.cu", "risingwave_tpu/storage/checkpoint_store.py:246",
        gms, gplain_ms, gb, None, err)
    out["dirty_gather_lanes"]["index_select_one_leaf"] = lib
    del eng, job, leaves, shk, shp, stk, stp, tree
    if cuda:
        torch.cuda.empty_cache()
    return out


def phase_q8_sharded_main_path(torch, device, scale):
    """bench's q8 sharded over 4 lanes through SQL at bench.py's sizes a
    lane: 9 warm-up and 8 timed barriers of 8 scheduling rounds (1 person
    and 3 auction chunks a lane each) with the launch counters and the
    host reads; then the audit (every loss counter 0), the lanes' rings
    against numpy over the consumed events and against the port's linear
    q8 over the same chunks (4 rounds a sharded round, its pools, tables
    and ring 4x as large)."""
    import numpy as np

    from risingwave_tpu_torch import kernels
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig

    cuda = device.type == "cuda"
    cfg = _q8_shard_config(scale)
    cap = cfg["chunk_capacity"]
    cpb = CHUNKS_PER_BARRIER if cuda else 2
    warm = WARMUP_BARRIERS if cuda else 1
    eng = _q8_sharded_engine(torch, device, cfg)
    job = eng.jobs[0]
    eng.tick(barriers=warm, chunks_per_barrier=cpb)
    if cuda:
        torch.cuda.synchronize()
    kernels.reset_launches()
    reads0 = (job.window_reads, job.barrier_reads)
    rows0 = eng.metrics.get("stream_rows_total", job="bench_mv")
    barriers = Q8_SHARD_BARRIERS if cuda else 1
    t0 = time.perf_counter()
    eng.tick(barriers=barriers, chunks_per_barrier=cpb)
    if cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    rows = barriers * cpb * 4 * SHARD_LANES * cap
    if eng.metrics.get("stream_rows_total", job="bench_mv") - rows0 != rows:
        fail("q8 sharded counted the wrong number of rows")
    reads = (job.window_reads - reads0[0], job.barrier_reads - reads0[1])
    rate = rows / dt
    rounds = barriers * cpb
    per = {k: launches[k] / rounds for k in ("crc32", "exchange",
                                             "join_emit", "join_update")}
    print(f"[main] q8 sharded {rows} rows (persons and auctions) in "
          f"{dt:.3f} s = {rate:.0f} rows/s on {SHARD_LANES} lanes; host "
          f"reads {reads[0]} emission totals + {reads[1]} barrier reads; "
          f"launches per round {per}; port kernel launches "
          f"{sum(launches.values()) / rounds:.1f} per round", flush=True)
    eng.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1")
    eng.tick(barriers=1, chunks_per_barrier=0)
    losses = {k: v for k, v in _loss_counters(eng).items() if v}
    if losses:
        fail(f"q8 sharded loss counters {losses}")
    print(f"[check] q8 sharded {check_q8(eng, cap, SHARD_LANES)}; every "
          "loss counter 0", flush=True)
    got = q8_ring_rows(eng, SHARD_LANES)
    p_off = job.sources["p"].offset
    del eng, job
    if cuda:
        torch.cuda.empty_cache()
    lin_cfg = dict(cfg)
    for k in ("join_left_table_size", "join_right_table_size",
              "join_pool_size", "mv_ring_size"):
        lin_cfg[k] = cfg[k] * SHARD_LANES
    lin = Engine(PlannerConfig(**lin_cfg), device=device)
    lin.execute(BENCH_SOURCES)
    lin.execute(QUERY_SQL["q8"])
    lin.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1000000")
    for _ in range(warm + barriers):
        lin.tick(barriers=1, chunks_per_barrier=cpb * SHARD_LANES)
    if lin.jobs[0].sources["p"].offset != p_off:
        fail(f"q8: the linear run consumed {lin.jobs[0].sources['p'].offset}"
             f" persons, the sharded {p_off}")
    lin.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1")
    lin.tick(barriers=1, chunks_per_barrier=0)
    want = q8_ring_rows(lin)
    if not np.array_equal(got, want):
        fail(f"q8 sharded ring ({len(got)} rows) differs from the linear "
             f"run's ({len(want)} rows) as a multiset")
    print(f"[check] q8 sharded ring equals the port's linear run over the "
          f"same {p_off} persons ({len(got)} rows)", flush=True)
    del lin
    if cuda:
        torch.cuda.empty_cache()
    return launches, rate


def phase_q8_sharded_durable(torch, device, scale):
    """q8 sharded durably (``data_dir``): 8 barriers with a snapshot every
    4 (K11 lanes over the stacked tree, then a lane delta through the
    uploader), then a cold start from the directory whose every state
    tensor equals the engine's that never stopped, before and after 2
    more barriers, with equal rings."""
    import gc
    import shutil
    import tempfile

    import numpy as np

    from risingwave_tpu_torch import kernels

    cuda = device.type == "cuda"
    cfg = _q8_shard_config(scale)
    cap = cfg["chunk_capacity"]
    per = CHUNKS_PER_BARRIER if cuda else 1
    n_b = 8 if cuda else 4
    data_dir = tempfile.mkdtemp(prefix="rw_sharded_q8_")
    try:
        eng = _q8_sharded_engine(torch, device, cfg, data_dir,
                                 snapshot=n_b // 2)
        if cuda:
            torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        eng.tick(barriers=n_b, chunks_per_barrier=per)
        if cuda:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        job, store = eng.jobs[0], eng.checkpoint_store
        rows = n_b * per * 4 * SHARD_LANES * cap
        rate = rows / dt
        commits = list(store.commits)
        print(f"[durable] q8 sharded {rows} rows in {dt:.3f} s = {rate:.0f} "
              f"rows/s ({n_b} barriers, {len(commits)} snapshots of "
              f"{job._shadow.total_blocks} lane blocks); committed epoch "
              f"{job.committed_epoch} = sealed {job.sealed_epoch}; commits "
              f"(kind, bytes, dirty blocks) "
              f"{[(c[2], c[3], c[4]) for c in commits]}", flush=True)
        if job.committed_epoch != job.sealed_epoch or not commits \
                or job._shadow.shard_rows != SHARD_LANES:
            fail("q8 sharded: nothing committed through the lane shadow")
        if cuda and any(c[2] == "delta" for c in commits) and \
                launches["dirty_gather_lanes"] <= 0:
            fail("q8 sharded: a lane delta without K11 lanes' gather")
        t0 = time.perf_counter()
        eng2 = _q8_sharded_engine(torch, device, cfg, data_dir,
                                  snapshot=n_b // 2)
        if cuda:
            torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
        _equal_states(torch, "q8 sharded cold start", eng2.jobs[0].states,
                      job.states)
        for name in ("p", "a"):
            if eng2.jobs[0].sources[name].offset != job.sources[name].offset:
                fail(f"q8 sharded cold start: reader {name} differs")
        for e in (eng, eng2):
            e.tick(barriers=2, chunks_per_barrier=per)
        _equal_states(torch, "q8 sharded after the cold start",
                      eng2.jobs[0].states, eng.jobs[0].states)
        if not np.array_equal(q8_ring_rows(eng, SHARD_LANES),
                              q8_ring_rows(eng2, SHARD_LANES)):
            fail("q8 sharded: ring rows differ after the cold start")
        print(f"[cold start] q8 sharded recovered the 4 lanes' epoch in "
              f"{rec_s:.3f} s; every state tensor equals the engine that "
              "never stopped, before and after 2 more barriers", flush=True)
        del eng, eng2, job
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        return launches, rate, {"recover_s": rec_s, "commits": [
            (c[2], c[3], c[4], c[5]) for c in commits]}
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)


def run_q8_sharded_paths(torch, device, scale, results) -> dict:
    """The slice's two paths; their launches join the kernels line.
    Returns {path: (rows/s, info)}."""
    out = {}
    for path in Q8_SHARD_PATHS:
        if path.endswith("durable"):
            launches, rate, info = phase_q8_sharded_durable(torch, device,
                                                            scale)
        else:
            launches, rate = phase_q8_sharded_main_path(torch, device, scale)
            info = {}
        out[path] = (rate, info)
        for name, n in launches.items():
            if name in results:
                results[name]["launches"] += n
                results[name]["launches_by_query"][path] = n
        missing = [k for k in Q8_SHARD_PATH_KERNELS[path] if launches[k] <= 0]
        if device.type == "cuda" and missing:
            fail(f"{path}: kernels {missing} were not launched on the path")
    return out


# ---------------------------------------------------------------------------
# 11. the vnode scale plane (slice 15): K25-K28

SCALE_VNODES = 64


def _gate_case(torch, cap: int, n_vnodes: int, g):
    """A chunk of ``cap`` rows for K25: random int64 keys (some extremes,
    some repeated), U-/U+ pairs every 5 rows, an unpaired U+ at row 0 and
    U- at row cap - 1 (their partners wrap around the capacity), a pair at
    rows cap - 3 and cap - 2, a tenth of the rows invalid; and a mask
    owning half the vnodes."""
    keys = torch.randint(-2**62, 2**62, (cap,), generator=g)
    keys[: cap // 4] = keys[: cap // 4] % 97
    keys[:4] = torch.tensor([0, -1, 2**63 - 1, -2**63])
    ops = torch.randint(0, 2, (cap,), generator=g).to(torch.int8)
    for i in range(1, cap - 3, 5):
        ops[i], ops[i + 1] = 2, 3
    ops[0], ops[cap - 1] = 3, 2
    ops[cap - 3], ops[cap - 2] = 2, 3
    valid = torch.rand(cap, generator=g) < 0.9
    mask = torch.zeros(n_vnodes, dtype=torch.bool)
    mask[torch.randperm(n_vnodes, generator=g)[: n_vnodes // 2]] = True
    return keys, ops, valid, mask


def _scale_tables(torch, device, size: int, g, bucket: int = 0):
    """A table of ``size`` slots, half filled with random keys and a fifth
    of its slots tombstoned, with slot-aligned leaves: an aggregation's
    (row_count, prev_row_count int64, dirty, emitted bool) or, with
    ``bucket``, a dense join side's ([size, B] occupied, int32 count)."""
    table, _ = _prefilled_table(torch, device, size, size // 2, g)
    if bucket:
        leaves = [(torch.rand(size, bucket, generator=g) < 0.5).to(device),
                  torch.randint(0, bucket, (size,), generator=g,
                                dtype=torch.int32).to(device)]
    else:
        leaves = [torch.randint(0, 1 << 20, (size,), generator=g).to(device),
                  torch.randint(0, 1 << 20, (size,), generator=g).to(device),
                  (torch.rand(size, generator=g) < 0.5).to(device),
                  (torch.rand(size, generator=g) < 0.5).to(device)]
    return table, leaves


def _clone_case(torch, table, leaves):
    return table.clone(), [x.clone() for x in leaves]


def phase_scale_kernels(torch, device, timer, scale):
    """K25 (the vnode gate) on 8192-row chunks with U-/U+ pairs at the
    edges, and its vnode form for 16, 24 and 64 vnodes; K26 (the vnode
    sweep, clear and read forms) and K27 (the transplant scatter after the
    probe kernel's claim) on a 2^18-slot aggregation table, an MV table
    and a dense join side; K28 (the troublemaker) over several chunks.
    Each against its plain version on the same inputs, exactly."""
    from risingwave_tpu_torch.cluster.scale.gate import (
        VnodeGateExecutor, gate_apply_plain)
    from risingwave_tpu_torch.cluster.scale.handover import (
        transplant_rows, transplant_rows_plain, vnode_sweep,
        vnode_sweep_plain)
    from risingwave_tpu_torch.cluster.scale.vnode import (
        vnodes_of_ints, vnodes_of_ints_plain)
    from risingwave_tpu_torch.common.chunk import Chunk
    from risingwave_tpu_torch.common.types import DataType, Field, Schema
    from risingwave_tpu_torch.expr.node import InputRef
    from risingwave_tpu_torch.stream.troublemaker import (
        TroublemakerExecutor, troublemaker_plain)

    g = torch.Generator(device="cpu").manual_seed(25)
    out = {}
    n = SCALE_VNODES
    # -- K25 --------------------------------------------------------------
    cap = 8192 // scale
    keys, ops, valid, mask = _gate_case(torch, cap, n, g)
    keys, ops, valid, mask = (x.to(device) for x in (keys, ops, valid, mask))
    pairs = []
    for nv in (16, 24, 64):
        pairs.append((f"vnodes of {nv}", vnodes_of_ints(keys, nv),
                      vnodes_of_ints_plain(keys, nv)))
    schema = Schema((Field("k", DataType.INT64, nullable=False),))
    gate = VnodeGateExecutor(schema, InputRef(0), n)
    chunk = Chunk((keys,), ops, valid, schema)
    start = torch.tensor(17, dtype=torch.int64, device=device)
    (m, dropped), got = gate.apply((mask, start.clone()), chunk)
    keep, want_ops, n_drop = gate_apply_plain(keys, mask, valid, ops, n)
    pairs += [("gate keep", got.valid, keep), ("gate ops", got.ops, want_ops),
              ("gate dropped", dropped, start + n_drop),
              ("gate mask", m, mask)]
    degraded = int((want_ops != ops).sum())
    err = max_abs_err(torch, pairs)
    ms = timer(lambda i: gate.apply((mask, start.clone()), chunk), 200)
    plain_ms = timer(lambda i: gate_apply_plain(keys, mask, valid, ops, n),
                     20)
    # per row: key 8 B, valid 1 B, op 1 B read; keep 1 B, op 1 B written;
    # the member mask (n bytes) once: it stays in cache; ~20 integer
    # operations a row
    b = bound(cap * 12 + n, cap * 20)
    print(f"[vnode_gate] exact ({cap} rows, {degraded} update halves "
          f"degraded, {int(n_drop)} rows dropped; vnodes of 16, 24 and 64 "
          f"exact); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{b[0]:.5f} ms", flush=True)
    out["vnode_gate"] = kernel_entry(
        "vnode_gate.cu", "risingwave_tpu/cluster/scale/gate.py:81", ms,
        plain_ms, b, None, err)
    # -- K26 --------------------------------------------------------------
    size = (1 << 18) // scale
    member = mask
    pairs, timed = [], {}
    cases = (("agg", 0), ("mv", -1), ("join side", 16))
    for name, bucket in cases:
        table, leaves = _scale_tables(torch, device, size, g, max(bucket, 0))
        if bucket < 0:
            leaves = []
        tk, lk = _clone_case(torch, table, leaves)
        tp, lp = _clone_case(torch, table, leaves)
        ck = vnode_sweep(tk, member, n, lk)
        cp = vnode_sweep_plain(tp, member, n, lp)
        rk = vnode_sweep(table, member, n, read=True)
        rp = vnode_sweep_plain(table, member, n, read=True)
        pairs += [(f"sweep {name} count", ck, cp),
                  (f"sweep {name} occupied", tk.occupied, tp.occupied),
                  (f"sweep {name} tombstone", tk.tombstone, tp.tombstone),
                  (f"sweep {name} read", rk, rp)]
        pairs += [(f"sweep {name} leaf {i}", a, bb)
                  for i, (a, bb) in enumerate(zip(lk, lp))]
        n_occ = int(table.occupied.sum())
        stale = int(cp)
        row = sum(x[0].numel() * x.element_size() for x in leaves)
        # occupancy read for every slot; the key (8 B) of the occupied
        # ones; the member mask once (it stays in cache); the stale slots'
        # planes (2 B) and leaf rows
        b = bound(size + n_occ * 8 + n + stale * (2 + row), size * 20)
        clones = [_clone_case(torch, table, leaves) for _ in range(11)]
        ms = timer(lambda i: vnode_sweep(clones[i][0], member, n,
                                         clones[i][1]), 10)
        pclones = [_clone_case(torch, table, leaves) for _ in range(4)]
        plain_ms = timer(lambda i: vnode_sweep_plain(
            pclones[i][0], member, n, pclones[i][1]), 3)
        timed[name] = (ms, plain_ms, b)
        print(f"[vnode_sweep] exact on the {name} table ({size} slots, "
              f"{n_occ} occupied, {stale} stale, {len(leaves)} leaves); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b[0]:.5f} ms", flush=True)
    err = max_abs_err(torch, pairs)
    # the entry is the aggregation table's clear, the scale paths' largest
    ms, plain_ms, b = timed["agg"]
    out["vnode_sweep"] = kernel_entry(
        "vnode_sweep.cu", "risingwave_tpu/cluster/scale/handover.py:153",
        ms, plain_ms, b, None, err)
    # -- K27 --------------------------------------------------------------
    n_moved = size // 8
    pairs, tms, pms, lib = [], [], [], None
    for name, bucket in cases:
        table, _ = _prefilled_table(torch, device, size, size // 4, g)
        mkeys = torch.randint(-2**62, 2**62, (n_moved,), generator=g)
        slots = table.lookup_or_insert(
            [mkeys.to(device)],
            torch.ones(n_moved, dtype=torch.bool, device=device))[1]
        slots[: 7] = size                      # dropped rows
        if bucket > 0:
            shapes = [((bucket,), torch.int64), ((bucket,), torch.int64),
                      ((bucket,), torch.bool), ((), torch.int32)]
        elif bucket == 0:
            shapes = [((), torch.int64)] * 8 + [((), torch.bool)] * 2
        else:
            shapes = [((), torch.int64)] * 4
        stores = [torch.zeros((size,) + s, dtype=dt, device=device)
                  for s, dt in shapes]
        srcs = [torch.randint(0, 2, (n_moved,) + s, generator=g).to(dt)
                if dt == torch.bool else
                torch.randint(-2**40, 2**40, (n_moved,) + s, generator=g
                              ).to(dt) for s, dt in shapes]
        srcs = [x.to(device) for x in srcs]
        sk = [x.clone() for x in stores]
        sp = [x.clone() for x in stores]
        transplant_rows(sk, srcs, slots, size)
        transplant_rows_plain(sp, srcs, slots, size)
        pairs += [(f"transplant {name} leaf {i}", a, bb)
                  for i, (a, bb) in enumerate(zip(sk, sp))]
        row = sum(x[0].numel() * x.element_size() for x in srcs)
        tms.append(timer(lambda i: transplant_rows(sk, srcs, slots, size),
                         20))
        pms.append(timer(lambda i: transplant_rows_plain(sp, srcs, slots,
                                                         size), 3))
        print(f"[vnode_transplant] exact on the {name} leaves ({n_moved} "
              f"moved entries, {len(srcs)} leaves, {row} B a row); kernel "
              f"{tms[-1]:.4f} ms, plain {pms[-1]:.4f} ms, bound "
              f"{bound(n_moved * (4 + 2 * row), n_moved * len(srcs))[0]:.5f}"
              " ms", flush=True)
        if bucket == 0:
            # one PyTorch call for the widest leaf (all 8 B leaves alike)
            keep = slots < size
            pos = slots[keep].to(torch.int64)
            lib = timer(lambda i: sk[0].index_put_((pos,), srcs[0][keep]),
                        20)
            agg_row = row
    err = max_abs_err(torch, pairs)
    b = bound(n_moved * (4 + 2 * agg_row), n_moved * 10)
    print(f"[vnode_transplant] index_put_ of the widest aggregation leaf: "
          f"{lib:.4f} ms (one of its 10 leaves)", flush=True)
    out["vnode_transplant"] = kernel_entry(
        "vnode_transplant.cu",
        "risingwave_tpu/cluster/scale/handover.py:387", tms[0], pms[0], b,
        lib, err)
    # -- K28 --------------------------------------------------------------
    tm = TroublemakerExecutor(schema, seed=7, ratio=3)
    ck = tm.init_state(device)
    cp = ck.clone()
    pairs, flipped = [], 0
    for c in range(4):
        ops = torch.randint(0, 4, (cap,), generator=g).to(torch.int8)
        valid = torch.rand(cap, generator=g) < 0.9
        ch = Chunk((keys,), ops.to(device), valid.to(device), schema)
        ck, got = tm.apply(ck, ch)
        cp, want = troublemaker_plain(cp, ch.valid, ch.ops, 7, 3)
        pairs += [(f"troublemaker ops {c}", got.ops, want),
                  (f"troublemaker counter {c}", ck, cp)]
        flipped += int((want != ch.ops).sum())
    err = max_abs_err(torch, pairs)
    ms = timer(lambda i: tm.apply(ck, ch), 200)
    plain_ms = timer(lambda i: troublemaker_plain(cp, ch.valid, ch.ops, 7, 3),
                     20)
    b = bound(cap * 3 + 16, cap * 12)
    print(f"[troublemaker] exact over 4 chunks ({flipped} inserts flipped, "
          f"ratio 3); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{b[0]:.5f} ms", flush=True)
    out["troublemaker"] = kernel_entry(
        "troublemaker.cu", "risingwave_tpu/stream/troublemaker.py:46", ms,
        plain_ms, b, None, err)
    return out


SCALE_BID = """CREATE SOURCE bid (
    auction BIGINT, bidder BIGINT, price BIGINT,
    channel VARCHAR, url VARCHAR, date_time TIMESTAMP
) WITH (connector = 'nexmark', nexmark.table = 'bid',
        nexmark.event.rate = '{rate}')"""
SCALE_AGG = """CREATE MATERIALIZED VIEW scale_agg AS
SELECT auction, count(*) AS bids, sum(price) AS volume,
       max(price) AS max_price FROM bid GROUP BY auction"""
SCALE_AGG_READ = "SELECT auction, bids, volume, max_price FROM scale_agg"
#: ``tests/test_scale.py``'s JOIN_DDL
SCALE_JOIN_DDL = [
    "CREATE TABLE ja (k BIGINT, v BIGINT)",
    "CREATE TABLE jb (k BIGINT, w BIGINT)",
    """CREATE MATERIALIZED VIEW jmv AS
       SELECT ja.k AS k, ja.v AS v, jb.w AS w
       FROM ja LEFT JOIN jb ON ja.k = jb.k""",
]
SCALE_JOIN_READ = "SELECT k, v, w FROM jmv"
SCALE_PATHS = ("scale_agg", "scale_join", "troublemaker")
#: the kernels each scale path must launch
SCALE_PATH_KERNELS = {
    "scale_agg": ("nexmark_bids", "vnode_gate", "vnode_sweep",
                  "vnode_transplant", "probe", "agg_scatter", "mv_upsert"),
    "scale_join": ("vnode_gate", "vnode_sweep", "vnode_transplant", "probe",
                   "join_dense", "mv_upsert"),
    "troublemaker": ("troublemaker",),
}
#: the scale_agg path: barriers between its handovers (24 in all)
SCALE_AGG_BARRIERS = 8


def _np_vnodes(keys, n: int):
    """numpy vnodes of int64 keys: the splitmix64 fold of one key word
    (seed 0), ~0 remapped to ~1, then the unsigned modulo."""
    import numpy as np

    k1 = np.uint64(0x9E3779B97F4A7C15)
    with np.errstate(over="ignore"):
        x = k1 ^ (np.asarray(keys, np.int64).view(np.uint64) * k1)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    x = np.where(x == ~np.uint64(0), ~np.uint64(1), x)
    return (x % np.uint64(n)).astype(np.int64)


class _ScaleModel:
    """numpy model of a scale run: each partition's owned vnodes, the
    rows its gates drop, and the keyed entries its tables hold (key ->
    entries: an aggregation group and its MV row; or a join key's left
    and right side entries and its MV rows), cleared and moved as
    ``repartition_job`` does."""

    def __init__(self, n_vnodes: int):
        self.n = n_vnodes
        self.own: dict = {}
        self.dropped: dict = {}
        self.tables: dict = {}

    def start(self, vmap) -> None:
        for w in sorted(set(vmap)):
            self.own[w] = {v for v, x in enumerate(vmap) if x == w}
            self.dropped[w] = 0
            self.tables[w] = {}

    def consume(self, sides: dict) -> None:
        """``sides``: {side: int64 keys of the rows every partition read};
        side "agg" adds 2 entries a key, "left"/"right" 1, "mv" 1 a row."""
        import numpy as np

        for side, keys in sides.items():
            if keys.shape[0] == 0:
                continue
            vn = _np_vnodes(keys, self.n)
            for w, own in self.own.items():
                ok = np.isin(vn, sorted(own))
                if side != "mv":  # the mv side's rows are ja's again
                    self.dropped[w] += int((~ok).sum())
                tab = self.tables[w]
                uk, cnt = np.unique(keys[ok], return_counts=True)
                for k, c in zip(uk.tolist(), cnt.tolist()):
                    e = tab.setdefault(k, {})
                    if side == "mv":
                        e["mv"] = e.get("mv", 0) + c
                    else:
                        e[side] = 2 if side == "agg" else 1

    def _in(self, w, vns):
        keys = list(self.tables[w])
        if not keys:
            return []
        import numpy as np

        vn = _np_vnodes(np.asarray(keys, np.int64), self.n)
        return [k for k, v in zip(keys, vn.tolist()) if v in vns]

    def scale(self, old, new) -> dict:
        """Apply one rebalance; returns {dst: (cleared, {src: entries})}."""
        gains: dict = {}
        for v, (a, b) in enumerate(zip(old, new)):
            if a != b:
                gains.setdefault(b, {}).setdefault(a, set()).add(v)
        out = {}
        for dst in sorted(gains):
            if dst not in self.own:
                self.own[dst], self.dropped[dst] = set(), 0
                self.tables[dst] = {}
            gained = set().union(*gains[dst].values())
            cleared = 0
            for k in self._in(dst, gained):
                cleared += sum(self.tables[dst].pop(k).values())
            moved = {}
            for src, vns in gains[dst].items():
                ks = self._in(src, vns)
                moved[src] = sum(sum(self.tables[src][k].values())
                                 for k in ks)
                for k in ks:
                    self.tables[dst][k] = dict(self.tables[src][k])
            out[dst] = (cleared, moved)
        for w in list(self.own):
            self.own[w] = {v for v, x in enumerate(new) if x == w}
            if not self.own[w]:
                del self.own[w], self.dropped[w], self.tables[w]
        return out


def _check_handover(path: str, res: dict, want: dict, lineages: dict):
    """``repartition_job``'s cleared counts and moved entries against the
    numpy model's."""
    by_lineage = {v: k for k, v in lineages.items()}
    for r in res["recipients"]:
        cleared, moved = want[r["worker"]]
        got = {by_lineage[t["ckpt"]]: t["entries"] for t in r["transfers"]}
        if r["cleared"] != cleared or got != moved:
            fail(f"{path}: worker {r['worker']} cleared {r['cleared']} and "
                 f"moved {got}, numpy {cleared} and {moved}")


def _check_dropped(path: str, driver, model) -> None:
    got = {w: s["gate_dropped"] for w, s in driver.stats().items()}
    if got != model.dropped:
        fail(f"{path}: gate_dropped {got}, numpy {model.dropped}")


def _chain_members(data_dir: str, lineages: dict) -> int:
    """npz members a handover's loads read: for each donor lineage, its
    chain from the last full epoch to the committed one (each delta holds
    one array per dirty run)."""
    import json
    import os

    import numpy as np

    with open(os.path.join(data_dir, "MANIFEST.json")) as f:
        jobs = json.load(f)["jobs"]
    total = 0
    for lineage in lineages:
        m = jobs[lineage]
        epochs = sorted(e for e in m["epochs"] if e <= m["committed"])
        base = max(e for e in epochs if m["kind"][str(e)] == "full")
        for e in epochs:
            if e >= base:
                with np.load(os.path.join(data_dir, lineage,
                                          f"epoch_{e}.npz")) as z:
                    total += len(z.files)
    return total


def _handover_ms(res: dict) -> dict:
    tot: dict = {}
    for r in res["recipients"]:
        for k, v in r["handover_ms"].items():
            tot[k] = tot.get(k, 0.0) + v
    return {k: round(v, 3) for k, v in tot.items()}


def _scale_loss_check(path: str, driver) -> None:
    """Every partition's loss counters after a maintenance barrier: 0."""
    for w, eng in sorted(driver.engines.items()):
        eng.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1")
        eng.tick(barriers=1, chunks_per_barrier=0)
        losses = {k: v for k, v in _loss_counters(eng).items() if v}
        if losses:
            fail(f"{path}: partition {w} loss counters {losses}")


def _scale_agg_config(scale: int) -> dict:
    return {k: v // scale if k != "agg_emit_capacity" else v
            for k, v in BENCH_CONFIG.items()}


def _scale_join_config(scale: int) -> dict:
    big = (1 << 18) // scale
    return dict(chunk_capacity=8192 // scale, join_table_size=big,
                join_pool_size=big, join_left_bucket_cap=16,
                join_right_bucket_cap=2, join_out_capacity=(1 << 16) // scale,
                mv_table_size=big, agg_table_size=1 << 10)


def _scale_engine(cfg: dict, device, data_dir=None, role="single"):
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig

    return Engine(PlannerConfig(**cfg), data_dir=data_dir, role=role,
                  device=device)


def _norm_rows(rows) -> list:
    return sorted(tuple(None if x is None else int(x) for x in r)
                  for r in rows)


def phase_scale_parity(torch, device) -> None:
    """Both scale scenarios at the CPU tests' small sizes on the card and
    on the CPU (plain versions; the aggregation forced onto the card's
    branch), step by step: the partitions' rows, ``partition_stats``,
    ``repartition_job``'s counts and every partition's state tensor."""
    import shutil
    import tempfile

    from risingwave_tpu_torch.cluster.scale.driver import ScaleDriver
    from risingwave_tpu_torch.common.tree import tree_map
    from risingwave_tpu_torch.stream import hash_agg

    card_branch = hash_agg.accel_tuned
    scenarios = {
        "scale_agg": ([SCALE_BID.format(rate="100000"), SCALE_AGG],
                      "scale_agg", 24, SCALE_AGG_READ,
                      dict(chunk_capacity=512, agg_table_size=1 << 10,
                           agg_emit_capacity=256, mv_table_size=1 << 10),
                      [([1, 2], None), ([1, 2, 3], None), ([1, 2], None)]),
        "scale_join": (SCALE_JOIN_DDL, "jmv", 16, SCALE_JOIN_READ,
                       dict(chunk_capacity=128, mv_table_size=1 << 10,
                            join_table_size=1 << 8, join_bucket_cap=16),
                       [([1], 0), ([1, 2], 1), ([1], 2)]),
    }
    for path, (ddl, name, n_vn, read, cfg, steps) in scenarios.items():
        dirs = [tempfile.mkdtemp(prefix="rw_scale_parity_")
                for _ in range(2)]
        try:
            def factory(data_dir, dev):
                return lambda w: _scale_engine(cfg, dev, data_dir, "compute")

            drivers = [ScaleDriver(factory(d, dv), ddl, name, n_vn)
                       for d, dv in zip(dirs, (device, torch.device("cpu")))]
            for i, (workers, phase) in enumerate(steps):
                res = []
                for d in drivers:
                    if i == 0:
                        d.start(workers)
                    else:
                        r = d.scale(workers)
                        for x in r["recipients"]:
                            x.pop("handover_ms")
                            x.pop("durable_epoch")
                        res.append(r)
                    if phase is not None:
                        _scale_join_dml(d, phase, 23, 220, 128)
                    if d.engines[workers[0]].device.type == "cpu":
                        hash_agg.accel_tuned = lambda dv: True
                    try:
                        d.tick(2, 1)
                    finally:
                        hash_agg.accel_tuned = card_branch
                if res and res[0] != res[1]:
                    fail(f"{path} parity: the handover differs: {res}")
                rows = [_norm_rows(d.rows(read)) for d in drivers]
                if rows[0] != rows[1] or not rows[0]:
                    fail(f"{path} parity: rows differ from the CPU's")
                if drivers[0].stats() != drivers[1].stats():
                    fail(f"{path} parity: partition_stats differ")
                for w in drivers[0].engines:
                    _equal_states(torch, f"{path} parity partition {w}",
                                  tree_map(lambda x: x.cpu(),
                                           drivers[0].job(w).states),
                                  drivers[1].job(w).states)
            print(f"[parity] {path} {' -> '.join(str(len(s[0])) for s in steps)}"
                  f" partitions: rows ({len(rows[0])}), partition_stats, "
                  "handover counts and every partition's state equal the "
                  "CPU plain versions", flush=True)
        finally:
            for d in dirs:
                shutil.rmtree(d, ignore_errors=True)


def _scale_join_dml(driver, phase: int, keys: int, n_a: int,
                    cap: int) -> tuple:
    """The DML of one phase of the join scenario, in INSERTs of ``cap``
    rows; ``ja`` row i (of ``n_a``) is (i % keys, i), ``jb`` key k's row
    (k, 3k + 1000).  Phase 0: jb's even keys, then half of ja; phase 1:
    jb's odd keys (the pads of their ja rows retract), a quarter of ja;
    phase 2: the last quarter.  Returns the (ja, jb) keys inserted."""
    import numpy as np

    lo, hi = {0: (0, n_a // 2), 1: (n_a // 2, 3 * n_a // 4),
              2: (3 * n_a // 4, n_a)}[phase]
    b = {0: range(0, keys, 2), 1: range(1, keys, 2), 2: range(0)}[phase]
    b = list(b)
    for i in range(0, len(b), cap):
        driver.execute_dml("INSERT INTO jb VALUES " + ",".join(
            f"({k},{3 * k + 1000})" for k in b[i:i + cap]))
    for i in range(lo, hi, cap):
        driver.execute_dml("INSERT INTO ja VALUES " + ",".join(
            f"({j % keys},{j})" for j in range(i, min(i + cap, hi))))
    return (np.arange(lo, hi, dtype=np.int64) % keys,
            np.asarray(b, np.int64))


def _scale_consumed(torch, driver, agg: bool, hist: dict, seen: dict,
                    cap: int) -> dict:
    """The keys every partition read since the last call, by side of the
    numpy model: the aggregation's bids, regenerated from the source's
    cursor; the join's rows, cut from the tables' histories at the
    readers' cursors."""
    import numpy as np

    eng = driver.engines[min(driver.engines)]
    job = driver.job(min(driver.engines))
    if agg:
        src, lo = job.source, seen.get("bid", 0)
        seen["bid"] = src.offset
        return {"agg": torch.cat([src.gen.gen_bids(i * cap, cap).columns[0]
                                  for i in range(lo // cap, src.offset // cap)]
                                 ).cpu().numpy()}
    offs = {eng._table_of_reader(r): r.offset for r in job.sources.values()}
    side = {}
    for t, name in (("ja", "left"), ("jb", "right")):
        side[name] = np.concatenate(hist[t])[seen.get(t, 0):offs[t]]
        seen[t] = offs[t]
    side["mv"] = side["left"]          # one MV row per ja row
    return side


def _scale_agg_want(torch, driver, cap: int, n_bids: int) -> list:
    """numpy's per-auction (count, sum, max) over the consumed bids."""
    import numpy as np

    src = driver.job(min(driver.engines)).source
    cols = [src.gen.gen_bids(i * cap, cap) for i in range(n_bids // cap)]
    auction = torch.cat([c.columns[0] for c in cols]).cpu().numpy()
    price = torch.cat([c.columns[2] for c in cols]).cpu().numpy()
    order = np.argsort(auction, kind="stable")
    a, p = auction[order], price[order]
    uniq, starts, counts = np.unique(a, return_index=True, return_counts=True)
    return [(int(u), int(c), int(p[s:s + c].sum()), int(p[s:s + c].max()))
            for u, s, c in zip(uniq, starts, counts)]


def phase_scale_path(torch, device, scale, path: str):
    """One scale path over 64 vnodes, partitions 2 -> 4 -> 2, each a
    ``role="compute"`` engine on the one card over one shared store, the
    handovers at the partitions' durable epochs.  The launch counters start
    at 0 and count the path's own calls (the DML, the barriers and the
    rescales), not the checks between them; ``scale_agg``'s bid chunks
    must number partitions x barriers x chunks a barrier.

    ``scale_agg``: bench's bid source without a watermark and the
    per-auction count, sum and max at bench.py's sizes (chunk 8192, 8
    chunks a barrier, agg table and MV 2^18, 1M events/s), 8 barriers a
    step.  ``scale_join``: ``tests/test_scale.py``'s JOIN_DDL (ja LEFT JOIN
    jb) at q13's DML scale: ``ja`` 131,072 rows over 16,384 keys, ``jb``
    16,384 rows (the even keys before the scale-out, the odd ones during
    it: their ja rows' pads retract), in INSERTs of 8192 rows, 4 rounds a
    barrier.

    Checks: the union of the partitions' reads against numpy and against
    the port's linear engine over the same input; each partition's
    gate_dropped and every handover's cleared and moved entries against
    the numpy model; every loss counter 0."""
    import shutil
    import tempfile

    from risingwave_tpu_torch import kernels
    from risingwave_tpu_torch.cluster.scale.driver import ScaleDriver
    from risingwave_tpu_torch.cluster.scale.vnode import (
        moved_vnodes, rebalance)

    cuda = device.type == "cuda"
    agg = path == "scale_agg"
    cfg = (_scale_agg_config if agg else _scale_join_config)(scale)
    cap = cfg["chunk_capacity"]
    keys = 16384 // scale
    ddl = [SCALE_BID.format(rate="1000000"), SCALE_AGG] if agg \
        else SCALE_JOIN_DDL
    name, read = ("scale_agg", SCALE_AGG_READ) if agg \
        else ("jmv", SCALE_JOIN_READ)
    cpb = (CHUNKS_PER_BARRIER if cuda else 2) if agg else 4
    # barriers a step: the join's INSERTs are 8, 4 and 4 chunks
    barriers = [SCALE_AGG_BARRIERS if cuda else 2] * 3 if agg else [2, 1, 1]
    n_vn = SCALE_VNODES
    data_dir = tempfile.mkdtemp(prefix=f"rw_{path}_")
    try:
        driver = ScaleDriver(lambda w: _scale_engine(cfg, device, data_dir,
                                                     "compute"),
                             ddl, name, n_vn)
        model = _ScaleModel(n_vn)
        driver.start([1, 2])
        model.start(driver.vmap)
        if cuda:
            torch.cuda.synchronize()
        kernels.reset_launches()
        hist, seen = {"ja": [], "jb": []}, {}
        clock = {"run": 0.0, "dml": 0.0}
        info = {"handover_ms": [], "entries": [], "chain_members": []}
        launches: dict = {}
        parts = []

        def timed(what, fn):
            """One call of the path (DML, barriers, a rescale), timed; its
            launches are counted, and the checks' between calls are not
            (the numpy model regenerates the bids it reads)."""
            before = dict(kernels.LAUNCHES)
            t0 = time.perf_counter()
            out = fn()
            if cuda:
                torch.cuda.synchronize()
            clock[what] += time.perf_counter() - t0
            for k, v in kernels.LAUNCHES.items():
                launches[k] = launches.get(k, 0) + v - before.get(k, 0)
            return out

        def run(step):
            if not agg:
                a, b = timed("dml", lambda: _scale_join_dml(
                    driver, step, keys, 8 * keys, cap))
                hist["ja"].append(a)
                hist["jb"].append(b)
            parts.append(len(driver.engines))
            timed("run", lambda: driver.tick(barriers[step], cpb))
            model.consume(_scale_consumed(torch, driver, agg, hist, seen,
                                          cap))

        run(0)
        for step, workers in ((1, [1, 2, 3, 4]), (2, [1, 2])):
            old = list(driver.vmap)
            lineages = dict(driver.lineages)
            donors = {lineages[a] for (a, _) in moved_vnodes(
                old, rebalance(old, workers, n_vn)) if a in lineages}
            info["chain_members"].append(_chain_members(data_dir, donors))
            res = timed("run", lambda: driver.scale(workers))
            _check_handover(path, res, model.scale(old, driver.vmap),
                            lineages)
            info["handover_ms"].append(_handover_ms(res))
            info["entries"].append(sum(t["entries"] for r in res["recipients"]
                                       for t in r["transfers"]))
            run(step)
            _check_dropped(path, driver, model)
        if agg:
            # every partition generates every chunk of every barrier
            want_bids = sum(p * b * cpb for p, b in zip(parts, barriers))
            if cuda and launches["nexmark_bids"] != want_bids:
                fail(f"{path}: {launches['nexmark_bids']} bid chunks "
                     f"generated on the path, expected {want_bids}")
            rows = sum(barriers) * cpb * cap
            want_seen = {"bid": rows}
            what = f"{rows} bids"
        else:
            rows = 9 * keys
            want_seen = {"ja": 8 * keys, "jb": keys}
            what = f"{rows} table rows ({8 * keys} ja, {keys} jb)"
        if seen != want_seen:
            fail(f"{path} consumed {seen}, expected {want_seen}")
        rate = rows / clock["run"]
        got = _norm_rows(driver.rows(read))
        want = _scale_agg_want(torch, driver, cap, rows) if agg else sorted(
            (i % keys, i, 3 * (i % keys) + 1000) for i in range(8 * keys))
        if got != want:
            fail(f"{path}: the partitions' union ({len(got)} rows) differs "
                 f"from numpy's ({len(want)} rows)")
        _scale_loss_check(path, driver)
        dropped = {w: s["gate_dropped"] for w, s in driver.stats().items()}
        dml_s = "" if agg else \
            f"; the INSERTs took {clock['dml']:.3f} s more"
        print(f"[main] {path} {what} in {clock['run']:.3f} s = {rate:.0f} "
              f"rows/s through 2 -> 4 -> 2 partitions (barriers and "
              f"handovers; every partition reads every row{dml_s}); "
              f"handover ms {info['handover_ms']}, moved entries "
              f"{info['entries']}; gate_dropped {dropped} equals numpy",
              flush=True)
        print(f"[check] {path} union of the partitions equals numpy over "
              f"{what} ({len(want)} rows); every handover's cleared and moved "
              "entries equal the numpy model; every loss counter 0",
              flush=True)
        dml = list(driver.dml_log)
        for eng in list(driver.engines.values()):
            eng.jobs.clear()
        del driver
        if cuda:
            torch.cuda.empty_cache()
        t_lin = time.perf_counter()
        lin = _scale_engine(dict(cfg), device)
        for sql in ddl + dml:
            lin.execute(sql)
        if agg:
            lin.tick(barriers=sum(barriers), chunks_per_barrier=cpb)
        else:
            lin.execute("FLUSH")
        if _norm_rows(lin.execute(read)) != got:
            fail(f"{path}: the partitions' union differs from the port's "
                 "linear engine over the same input")
        info["linear_s"] = time.perf_counter() - t_lin
        print(f"[check] {path} union equals the port's linear engine over "
              f"the same input", flush=True)
        del lin
        if cuda:
            torch.cuda.empty_cache()
        info["rows"] = rows
        return launches, rate, info
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)


def phase_troublemaker_path(torch, device, scale):
    """``tests/test_ctl.py``'s troublemaker scenario on the card, at one
    chunk of 8192 rows: a troublemaker fragment (seed 7, ratio 4) feeds a
    hash join's left side.  The flipped ops equal the plain version's, and
    the side's inconsistency is above 0 and equal to the CPU run's."""
    from risingwave_tpu_torch import kernels
    from risingwave_tpu_torch.common.chunk import Chunk
    from risingwave_tpu_torch.common.types import DataType, Schema
    from risingwave_tpu_torch.expr.node import InputRef
    from risingwave_tpu_torch.stream.fragment import Fragment
    from risingwave_tpu_torch.stream.hash_join import HashJoinExecutor
    from risingwave_tpu_torch.stream.troublemaker import (
        TroublemakerExecutor, troublemaker_plain)

    cap = 8192 // scale
    schema = Schema.of(("k", DataType.INT64), ("v", DataType.INT64))
    out = {}
    if device.type == "cuda":
        torch.cuda.synchronize()
    kernels.reset_launches()
    for dev in (device, torch.device("cpu")):
        frag = Fragment([TroublemakerExecutor(schema, seed=7, ratio=4)])
        st = frag.init_states(dev)
        k = torch.arange(cap, dtype=torch.int64, device=dev)
        chunk = Chunk((k, k.clone()), torch.zeros(cap, dtype=torch.int8,
                                                  device=dev),
                      torch.ones(cap, dtype=torch.bool, device=dev), schema)
        st, got = frag.step(st, chunk)
        join = HashJoinExecutor(schema, schema, [InputRef(0)], [InputRef(0)],
                                table_size=2 * cap, bucket_cap=4,
                                out_capacity=2 * cap)
        jst, _ = join.apply_begin(join.init_state(dev), got, "left")
        out[dev.type] = (got.ops.cpu(), int(jst.left.inconsistency))
        if dev == device:
            launches = dict(kernels.LAUNCHES)
            _, want = troublemaker_plain(
                torch.zeros((), dtype=torch.int64, device=dev), chunk.valid,
                chunk.ops, 7, 4)
            max_abs_err(torch, [("troublemaker path ops", got.ops, want)])
    (ops, inc), (cops, cinc) = out[device.type], out["cpu"]
    if not torch.equal(ops, cops) or inc <= 0 or inc != cinc:
        fail(f"troublemaker: inconsistency {inc} on the card, {cinc} on the "
             "CPU (must be equal and above 0)")
    print(f"[check] troublemaker path: {int((ops == 1).sum())} of {cap} "
          f"inserts flipped, equal to the plain version's; the join side "
          f"counted {inc} inconsistencies, as the CPU run", flush=True)
    return launches, 0.0, {"inconsistency": inc}


def run_scale_paths(torch, device, scale, results, secs: dict) -> dict:
    """The slice's paths; their launches join the kernels line and their
    wall seconds ``secs``.  Returns {path: (rows/s, info)}."""
    t0 = time.perf_counter()
    phase_scale_parity(torch, device)
    secs["parity"] = time.perf_counter() - t0
    out = {}
    for path in SCALE_PATHS:
        t0 = time.perf_counter()
        if path == "troublemaker":
            launches, rate, info = phase_troublemaker_path(torch, device,
                                                           scale)
        else:
            launches, rate, info = phase_scale_path(torch, device, scale,
                                                    path)
        out[path] = (rate, info)
        secs[path] = time.perf_counter() - t0
        if "linear_s" in info:
            secs[path] -= info["linear_s"]
            secs[f"{path}'s linear rerun"] = info["linear_s"]
        for name, n in launches.items():
            if name in results:
                results[name]["launches"] += n
                results[name]["launches_by_query"][path] = n
        missing = [k for k in SCALE_PATH_KERNELS[path] if launches[k] <= 0]
        if device.type == "cuda" and missing:
            fail(f"{path}: kernels {missing} were not launched on the path")
    return out


if __name__ == "__main__":
    sys.exit(main())
