#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the hand-written CUDA kernels from ``risingwave_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel) and prints the build time;
2. holds each kernel against its plain PyTorch version on the card at
   the shapes Nexmark q7 gives it (8192-row chunks, 2^18-slot tables
   half full, with tombstones), requiring exact equality, and times
   kernel, plain version, one PyTorch library call where one exists,
   and the card's bound for the same bytes;
3. runs q7 through the port's ``Engine`` at ``bench.py``'s sizes (9
   warm-up barriers, then 32 timed barriers of 8 chunks) with the
   launch counters set to 0 just before and read just after, and
   requires every kernel to have launched;
4. checks the MV against a numpy recomputation of max(price) and
   count(*) per 10-second window over the bids the port generated;
5. prints the ``kernels`` JSON line, the card's name and power limit,
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

Q7_CONFIG = dict(chunk_capacity=8192, agg_table_size=1 << 18,
                 agg_emit_capacity=4096, mv_table_size=1 << 18)
WARMUP_BARRIERS = 9
BARRIERS = 32
CHUNKS_PER_BARRIER = 8
WINDOW_US = 10_000_000


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(code)


class Timer:
    """Mean milliseconds per call of ``fn(i)`` over ``iters`` calls:
    CUDA events on the card, the host clock in a CPU rehearsal."""

    def __init__(self, torch, device):
        self.torch = torch
        self.cuda = device.type == "cuda"

    def __call__(self, fn, iters: int) -> float:
        torch = self.torch
        fn(iters)  # warm up (and build on first use) on its own input
        if self.cuda:
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for i in range(iters):
                fn(i)
            e1.record()
            torch.cuda.synchronize()
            return e0.elapsed_time(e1) / iters
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        return (time.perf_counter() - t0) * 1e3 / iters


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, pairs) -> float:
    """Max |a - b| over pairs of tensors; any difference fails the run
    (every comparison here is exact: the q7 path is integer)."""
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

    import torch

    if not (ROOT / "risingwave_tpu_torch" / "csrc").is_dir():
        fail("run from a checkout of the repository (package not found)", 2)
    sys.path.insert(0, str(ROOT))
    if args.rehearse:
        device = torch.device("cpu")
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

    timer = Timer(torch, device)
    scale = 1 if device.type == "cuda" else 64
    results = {}
    results["hash64"] = phase_hash(torch, device, timer, scale)
    results["probe"] = phase_probe(torch, device, timer, scale)
    results["agg_scatter"] = phase_agg(torch, device, timer, scale)
    results["mv_upsert"] = phase_mv(torch, device, timer, scale)
    phase_engine_parity(torch, device)

    # -- 3. main path ---------------------------------------------------
    launches, rate = phase_main_path(torch, device, scale)
    for name, n in launches.items():
        results[name]["launches"] = n
        if device.type == "cuda" and n <= 0:
            fail(f"kernel {name} was not launched on the main path")

    line = {"kernels": [dict(name=name, **r) for name, r in results.items()]}
    print(json.dumps(line))
    if device.type != "cuda":
        print("chip_smoke: CPU rehearsal passed (no device result)")
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[main] q7 rows/s {rate:.0f}")
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


def phase_probe(torch, device, timer, scale):
    g = torch.Generator(device="cpu").manual_seed(2)
    size, cap = (1 << 18) // scale, 8192 // scale
    base, tkeys = _prefilled_table(torch, device, size, size // 2, g)
    keys = _probe_chunk(torch, tkeys, cap, g).to(device)
    valid = (torch.rand(cap, generator=g) < 0.95).to(device)
    pairs = []
    for insert in (True, False):
        tk, tp = base.clone(), base.clone()
        rk = tk._probe([keys], valid, insert)
        rp = tp._probe_plain([keys], valid, insert)
        if insert:
            n_inserted = int(rp[2].sum())
        tag = "insert" if insert else "lookup"
        for name, a, b in (("slots", rk[1], rp[1]), ("inserted/found",
                                                     rk[2], rp[2]),
                           ("overflow", rk[3], rp[3]),
                           ("n_over", rk[4], rp[4]),
                           ("occupied", tk.occupied, tp.occupied),
                           ("tombstone", tk.tombstone, tp.tombstone),
                           ("key store", tk.key_cols[0], tp.key_cols[0])):
            pairs.append((f"probe {tag} {name}", a, b))
    err = max_abs_err(torch, pairs)
    n_it = 20
    clones = [base.clone() for _ in range(n_it + 1)]
    ms = timer(lambda i: clones[i].lookup_or_insert([keys], valid), n_it)
    pclones = [base.clone() for _ in range(4)]
    plain_ms = timer(lambda i: pclones[i]._probe_plain([keys], valid, True),
                     3)
    # chunk: key 8 B + valid 1 B read; slot 4 B + flags 2 B written; one
    # probe read per row (occupied, tombstone, key: 10 B) and a key +
    # occupied write per claimed slot
    nbytes = cap * (8 + 1 + 6 + 10) + n_inserted * 9
    b = bound(nbytes, cap * 30)
    print(f"[probe] exact (slot layout, insert and lookup); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b[0]:.5f} ms",
          flush=True)
    return kernel_entry("probe.cu", "risingwave_tpu/state/hash_table.py:236",
                        ms, plain_ms, b, None, err)


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
    library_ms = timer(lambda i: last.scatter_reduce_(
        0, tgt, row_idx, reduce="amax"), 200)
    n_rows = 2 * half
    # per row: slot 4 B, op 1 B, valid 1 B, 24 B of values; per winning
    # slot 24 B of values + 2 B of flags written
    b = bound(n_rows * 30 + half * 26, n_rows * 8)
    print(f"[mv_upsert] exact; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library {library_ms:.4f} ms, bound {b[0]:.5f} ms", flush=True)
    return kernel_entry("mv_upsert.cu",
                        "risingwave_tpu/stream/materialize.py:108",
                        ms, plain_ms, b, library_ms, err)


# ---------------------------------------------------------------------------
# 3-4. main path + result check


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

Q7 = """
CREATE MATERIALIZED VIEW bench_mv AS
SELECT window_start, max(price) AS max_price, count(*) AS bids
FROM TUMBLE(bid, date_time, INTERVAL '10' SECOND)
GROUP BY window_start;
"""


def phase_engine_parity(torch, device) -> None:
    """q7 at 2 events/s through the engine on ``device`` and on the CPU
    (plain versions), small tables: hundreds of windows, watermark
    cleaning, tombstones, rehash at maintenance and a multi-round emit
    drain all run through the kernels.  MV rows and every state tensor
    must be equal."""
    from risingwave_tpu_torch.compat import state_mismatches, state_to_numpy
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig

    cfg = PlannerConfig(chunk_capacity=256, agg_table_size=1 << 10,
                        agg_emit_capacity=16, mv_table_size=1 << 10)
    engines = []
    for dev in (device, torch.device("cpu")):
        eng = Engine(cfg, device=dev)
        eng.execute(BENCH_SOURCES.replace("'1000000'", "'2'"))
        eng.execute(Q7)
        eng.tick(barriers=10, chunks_per_barrier=4)
        engines.append(eng)
    rows = [sorted(tuple(int(v) for v in r)
                   for r in e.execute("SELECT * FROM bench_mv"))
            for e in engines]
    if rows[0] != rows[1]:
        fail("q7 MV on the card differs from the CPU plain versions")
    bad = state_mismatches(state_to_numpy(engines[1].jobs[0].states),
                           engines[0].jobs[0].states)
    if bad:
        fail(f"q7 state on the card differs from the CPU: {bad[:5]}")
    agg = engines[0].jobs[0].states[2]
    print(f"[parity] q7 at 2 events/s, 10 barriers: {len(rows[0])} MV rows "
          f"and all state equal to the CPU plain versions "
          f"({int(agg.table.tombstone_count())} agg tombstones left after "
          f"rehash)", flush=True)


def profile_window(torch, eng) -> None:
    """Two more barriers under torch.profiler: device busy time (the sum
    of CUDA kernel times on the one stream), kernels launched per chunk,
    the share of the port's own kernels, and the top kernels.  The
    profiler slows the host, so its wall time is only the denominator of
    the busy share it reports, not a rate."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.tick(barriers=2, chunks_per_barrier=CHUNKS_PER_BARRIER)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in kern) / 1e3
    if busy_ms == 0:
        print("[profile] device time not measured (no CUDA kernel "
              "recorded)", flush=True)
        return
    ours = ("hash64_kernel", "probe_kernel", "reset_kernel",
            "scatter_kernel", "mark_kernel", "apply_kernel")
    ours_ms = sum(dev_us(e) for e in kern if e.key.startswith(ours)) / 1e3
    n_kern = sum(e.count for e in kern)
    chunks = 2 * CHUNKS_PER_BARRIER
    print(f"[profile] 2 barriers x {CHUNKS_PER_BARRIER} chunks: wall "
          f"{wall_ms:.2f} ms (profiled), device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), port kernels "
          f"{ours_ms:.3f} ms, {n_kern} kernel launches "
          f"({n_kern / chunks:.1f} per chunk)", flush=True)
    for e in sorted(kern, key=lambda e: -dev_us(e))[:12]:
        print(f"[profile]   {dev_us(e) / 1e3:8.3f} ms  x{e.count:5d}  "
              f"{e.key[:100]}", flush=True)

    # launches by layer for one chunk (the step runs on a clone: the
    # job's own state must stay as the timed run left it)
    from risingwave_tpu_torch.stream.runtime import clone_tree

    job = eng.jobs[0]
    gen, cap = job.source.gen, job.source.cap
    states = clone_tree(job.states)
    chunk = gen.gen_bids(0, cap)
    for name, fn in (("generator", lambda: gen.gen_bids(0, cap)),
                     ("fragment step", lambda: job.fragment.step(states,
                                                                 chunk))):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        k = [e for e in prof.key_averages()
             if getattr(e, "device_type", None) == DeviceType.CUDA]
        print(f"[profile] one chunk, {name}: "
              f"{sum(e.count for e in k)} kernel launches, "
              f"{sum(dev_us(e) for e in k) / 1e3:.3f} ms device", flush=True)


def phase_main_path(torch, device, scale):
    import numpy as np

    from risingwave_tpu_torch import kernels
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig

    cfg = {k: v // scale for k, v in Q7_CONFIG.items()}
    eng = Engine(PlannerConfig(**cfg), device=device)
    eng.execute(BENCH_SOURCES)
    eng.execute(Q7)
    eng.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1000000")
    eng.execute("ALTER SYSTEM SET snapshot_interval_checkpoints = 8")
    eng.tick(barriers=WARMUP_BARRIERS, chunks_per_barrier=CHUNKS_PER_BARRIER)
    if device.type == "cuda":
        torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    eng.tick(barriers=BARRIERS, chunks_per_barrier=CHUNKS_PER_BARRIER)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    cap = cfg["chunk_capacity"]
    rows = BARRIERS * CHUNKS_PER_BARRIER * cap
    rate = rows / dt
    print(f"[main] q7 {rows} rows in {dt:.3f} s = {rate:.0f} rows/s; "
          f"launches {launches}", flush=True)
    if device.type == "cuda":
        profile_window(torch, eng)
    # post-window consistency audit: counters are read and raise on
    # overflow / inconsistency
    eng.execute("ALTER SYSTEM SET maintenance_interval_checkpoints = 1")
    eng.tick(barriers=1, chunks_per_barrier=0)

    # -- 4. result check against numpy over the generated bids -----------
    got = sorted(tuple(int(v) for v in r)
                 for r in eng.execute("SELECT * FROM bench_mv"))
    reader = eng.jobs[0].source
    n_chunks = reader.offset // cap   # every chunk the job consumed
    price, ts = [], []
    for i in range(n_chunks):
        c = reader.gen.gen_bids(i * cap, cap)
        price.append(c.columns[2].cpu().numpy())
        ts.append(c.columns[5].cpu().numpy())
    price, ts = np.concatenate(price), np.concatenate(ts)
    ws = ts - ts % WINDOW_US
    want = []
    for w in np.unique(ws):
        sel = ws == w
        want.append((int(w), int(price[sel].max()), int(sel.sum())))
    if got != want:
        fail(f"MV differs from the numpy recomputation: {got[:4]} vs "
             f"{want[:4]}")
    print(f"[check] MV equals numpy max/count per window over "
          f"{price.shape[0]} bids ({len(want)} windows)", flush=True)
    return launches, rate


if __name__ == "__main__":
    sys.exit(main())
