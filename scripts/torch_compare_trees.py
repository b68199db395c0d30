"""Time kernels and paths of one checkout of the PyTorch port on the card.

    python3 scripts/torch_compare_trees.py ROOT [--only K,...] [--paths]
        [--main Q,...] [--launches Q,...]

ROOT is the root of a checkout (its ``chip_smoke.py`` and
``risingwave_tpu_torch`` are imported from there, its kernels built under
ROOT/build/kernels).  To compare two commits on one card, unpack the other
one with ``git archive`` into a directory that ``.gitignore`` lists and run
this in turns from both, in one call: parent, change, change, parent.
The timed kernels (all by default, or those ``--only`` names):
  k5    K5 at the pane agg's chunk and q5 sharded's lane;
  k12   K12 ranked on a bench-size q8 engine's auction side;
  k8    K8-ring at q1's (4 int64) and q22's (176 B string rows) shapes;
  k16   K16 at q19's shape (a bench-size q19 engine's next 8 chunks) and
        at ow_bid's (8192 bids into a 2^22 pool with 2,818,048 live);
  k18   K18 at q19's shape (the band diff of that pool after its 8
        chunks against the emitted band, the two sorts included) and its
        membership at ow_bid's (2 x 2^22 entries, 2,818,048 live);
  k20   K20 on q6_bid's over-window state after the top-N's next flush
        (pool 2^18, emit 2^16), alone and in the whole flush.
The K8, K16 and K18 ow_bid shapes are built by this script's own
checkout's ``chip_smoke.py`` (``ring_shape``, ``k16_ow_bid_shape``,
``k18_ow_bid_shape``) over ROOT's port, so an older ROOT gets the same
inputs.  K20 at ow_bid's pool is ``--main ow_bid``'s.  Kernel times are device
times (CUDA events over calls queued behind a sleep); ``--paths`` adds
chip_smoke's q5-sharded and q8 main paths of ROOT (their rows/s and
profiled windows); ``--main Q[,Q...]`` adds chip_smoke's main path of
each query Q of ROOT (q1, q5, q7, q19, q18, q6_bid, ow_bid, q22, q10, q21:
rows/s, launches and the profiled window); ``--launches Q[,Q...]`` adds,
for each of the string,
top-N and window queries Q (q22, q10, q21, q19, q18, q6_bid, ow_bid), the
CUDA kernels launched in a profiled window of 2 barriers x 8 chunks after
chip_smoke's warm-up, by name, on ROOT.  Prints one ``[compare]`` JSON line
(and one ``[launches]`` line per query); needs a card.
"""

import importlib.util
import json
import sys
import time
from pathlib import Path

root = sys.argv[1]
sys.path.insert(0, root)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from risingwave_tpu_torch.common.hash import hash64_columns  # noqa: E402
from risingwave_tpu_torch.common.tree import tree_map  # noqa: E402
from risingwave_tpu_torch.stream import hash_agg as ha  # noqa: E402
from risingwave_tpu_torch.stream import hash_join as hj  # noqa: E402
from risingwave_tpu_torch.stream import materialize as mat  # noqa: E402
from risingwave_tpu_torch.stream import top_n  # noqa: E402

# this checkout's chip_smoke: the K8 and K16 shapes, over ROOT's port
_spec = importlib.util.spec_from_file_location(
    "chip_smoke_here", Path(__file__).resolve().parent.parent /
    "chip_smoke.py")
here = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(here)


#: host milliseconds a call took to enqueue, by the last ``timed`` call
HOST_MS = [0.0]


def timed(fn, iters: int) -> float:
    """Device ms a call of ``fn(i)`` over ``iters`` calls (the host's
    enqueue time a call goes to ``HOST_MS[0]``)."""
    fn(iters)
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(min(iters * 1.0, 200.0) * cs.CYCLES_PER_MS))
    e0.record()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    HOST_MS[0] = (time.perf_counter() - t0) * 1e3 / iters
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def k5_pane(dev):
    """The pane agg's chunk: 8192 rows on (auction, window), 99 in 100 on
    one auction; count, max(price), min(int32)."""
    g = torch.Generator(device="cpu").manual_seed(5)
    cap = 8192
    hot = torch.rand(cap, generator=g) < 0.99
    auction = torch.where(hot, torch.tensor(1300),
                          torch.randint(1000, 1400, (cap,), generator=g))
    ws = torch.randint(0, 3, (cap,), generator=g) * cs.HOP_SLIDE_US \
        + 1_436_918_400_000_000
    valid = (torch.rand(cap, generator=g) < 0.98).to(dev)
    keys = [auction.to(dev), ws.to(dev)]
    signs = torch.ones(cap, dtype=torch.int32, device=dev)
    price = torch.randint(100, 10**8, (cap,), generator=g).to(dev)
    qty = torch.randint(-2**31, 2**31 - 1, (cap,), generator=g,
                        dtype=torch.int32).to(dev)
    sk, perm = ha.sort_by_hash(hash64_columns(keys), valid)
    return (sk, perm, keys, valid, signs, ["add", "max", "min"],
            [0, -2**63, 2**31 - 1], [signs.to(torch.int64), price, qty])


def k5_lane(dev):
    """q5 sharded's keyed half on one lane: 163,840 received rows, 420
    valid, on (auction, window_start), the partial counts summed."""
    rng = np.random.default_rng(59)
    n = 163_840
    valid = np.zeros(n, bool)
    valid[rng.choice(n, 420, replace=False)] = True
    auction = np.where(valid, rng.integers(1000, 1040, n), 0)
    ws = np.where(valid, rng.integers(0, 3, n) * cs.HOP_SLIDE_US
                  + 1_436_918_400_000_000, 0)
    counts = np.where(valid, rng.integers(1, 40, n), 0)
    keys = [torch.from_numpy(auction).to(dev), torch.from_numpy(ws).to(dev)]
    lv = torch.from_numpy(valid).to(dev)
    sk, perm = ha.sort_by_hash(hash64_columns(keys), lv)
    return (sk, perm, keys, lv, lv.to(torch.int32), ["add"], [0],
            [torch.from_numpy(counts).to(dev)])


def k12_q8(dev):
    """The auction side of a bench-size q8 engine after 10 barriers and
    the next auction chunk: the ranked insert's arguments."""
    eng = cs._q8_engine(torch, dev, 1, 10)
    job = eng.jobs[0]
    join = job.nodes[2].join

    def clone(t):
        return tree_map(torch.clone, t)

    js = clone(job.states[2])
    _, pchunk = job.nodes[0].fragment.step(clone(job.states[0]),
                                           job.sources["p"].next_chunk())
    js, _ = join.apply_begin(js, pchunk, "left")
    _, achunk = job.nodes[1].fragment.step(clone(job.states[1]),
                                           job.sources["a"].next_chunk())
    key_cols, null_keys = hj._null_stripped_keys(
        [e.eval(achunk) for e in join.right_keys])
    h = hash64_columns(key_cols)
    is_ins = hj.insert_mask(achunk, null_keys)
    cr = hj._rank_by_sorted(h, is_ins)[0]
    return js.right, h, cr, is_ins


def k8_times(dev, out):
    """K8-ring at q1's and q22's shapes into the 2^23 ring."""
    ring, cap = 1 << 23, 8192
    for tag, fields in (("q1", here.Q1_RING_FIELDS),
                        ("q22", here.Q22_RING_FIELDS)):
        st, chunk = here.ring_shape(torch, dev, fields, cap, ring, 7)
        out[f"k8_{tag}_ms"] = timed(
            lambda i: mat.ring_append(*st, chunk, ring), 200)
        out[f"k8_{tag}_host_ms"] = HOST_MS[0]


def k16_times(dev, out):
    """K16 at q19's shape (the TopN state of a bench-size q19 engine
    after 9 barriers and its next 8 chunks) and at ow_bid's."""
    eng = cs._topn_engine(torch, dev, 1, "q19", cs.WARMUP_BARRIERS)
    ti = cs._topn_index(eng)
    S = eng.jobs[0].fragment.executors[ti].pool_size
    base = eng.jobs[0].states[ti]
    chunks = cs._topn_inputs(torch, eng, cs.CHUNKS_PER_BARRIER)
    t = tree_map(torch.clone, base)
    out["k16_q19_ms"] = timed(lambda i: top_n.pool_apply_cuda(
        t.rows, t.valid, t.row_hash, chunks[i % len(chunks)], S, t.overflow,
        t.inconsistency), 8)
    del eng, base, t
    pool, chunk, S, live = here.k16_ow_bid_shape(torch, dev, 1)

    def run(i):
        pool[1][live:].zero_()
        top_n.pool_apply_cuda(*pool[:3], chunk, S, *pool[3:])

    out["k16_ow_bid_ms"] = timed(run, 20)


def k18_times(dev, out):
    """K18 at q19's shape (``phase_topn_kernels``' band diff) and its
    membership at ow_bid's shape."""
    from risingwave_tpu_torch.common.compact import mask_indices

    eng = cs._topn_engine(torch, dev, 1, "q19", cs.WARMUP_BARRIERS)
    ti = cs._topn_index(eng)
    tex = eng.jobs[0].fragment.executors[ti]
    S, E = tex.pool_size, tex.emit_capacity
    base = eng.jobs[0].states[ti]
    a = tree_map(torch.clone, base)
    for c in cs._topn_inputs(torch, eng, cs.CHUNKS_PER_BARRIER):
        top_n.pool_apply_cuda(a.rows, a.valid, a.row_hash, c, S, a.overflow,
                              a.inconsistency)
    order_cols, desc, group_cols = tex.band_inputs(a)
    band, ranks = top_n.band_mask_cuda(order_cols, desc, group_cols, a.valid,
                                       tex.offset, tex.limit)
    args = (a.rows, a.row_hash, ranks, mask_indices(band, E, S),
            base.prev_rows, base.prev_valid, base.prev_hash)
    out["k18_q19_ms"] = timed(lambda i: top_n.band_diff_cuda(*args), 20)
    del eng, base, a, args
    sides = here.k18_ow_bid_shape(torch, dev, 1)[:4]
    out["k18_member_ow_bid_ms"] = timed(
        lambda i: top_n.band_membership_cuda(*sides), 10)


def k20_times(dev, out):
    """K20 on q6_bid's over-window state after the top-N's next flush, as
    ``phase_window_kernels`` times it: alone and in the whole flush."""
    eng = cs._window_engine(torch, dev, 1, "q6_bid", cs.WARMUP_BARRIERS)
    job = eng.jobs[0]
    oi = cs._executor_index(eng, "OverWindowExecutor")
    tix = cs._executor_index(eng, "GroupTopNExecutor")
    ow, tex = job.fragment.executors[oi], job.fragment.executors[tix]
    tst = tree_map(torch.clone, job.states[tix])
    for c in cs._topn_inputs(torch, eng, cs.CHUNKS_PER_BARRIER):
        tex.apply(tst, c)
    _, chunk = tex.flush(tst, 0)
    for i in range(tix + 1, oi):
        _, chunk = job.fragment.executors[i].apply((), chunk)
    st, _ = ow.apply(tree_map(torch.clone, job.states[oi]), chunk)
    sorted_args = ow.sorted_order_cuda(st)
    out["k20_q6_bid_ms"] = timed(
        lambda i: ow.window_rows_cuda(st, *sorted_args), 20)
    out["k20_q6_bid_flush_ms"] = timed(lambda i: ow.flush_cuda(st), 10)


def launches_by_kernel(dev, query: str) -> dict:
    """{kernel name: launches} over a profiled window of ``query`` (2
    barriers x 8 chunks after the warm-up barriers), and the total."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if query in cs.STRING_QUERIES:
        eng = cs._string_engine(torch, dev, 1, query, cs.WARMUP_BARRIERS)
    elif query in cs.TOPN_QUERIES:
        eng = cs._topn_engine(torch, dev, 1, query, cs.WARMUP_BARRIERS)
    else:
        eng = cs._window_engine(torch, dev, 1, query, cs.WARMUP_BARRIERS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.tick(barriers=2, chunks_per_barrier=cs.CHUNKS_PER_BARRIER)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            name = cs.kernel_name(e.key).split("(")[0][:80]
            out[name] = out.get(name, 0) + e.count
    return {"total": sum(out.values()), "by_kernel": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_compare_trees: no card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    only = None
    if "--only" in sys.argv:
        only = set(sys.argv[sys.argv.index("--only") + 1].split(","))
    out = {"tree": root, "card": torch.cuda.get_device_name(0)}
    if only is None or "k5" in only:
        pane, lane = k5_pane(dev), k5_lane(dev)
        out["k5_pane_ms"] = timed(lambda i: ha.agg_preagg_cuda(*pane), 200)
        out["k5_lane_ms"] = timed(lambda i: ha.agg_preagg_cuda(*lane), 20)
    if only is None or "k12" in only:
        side, h, cr, is_ins = k12_q8(dev)
        tables = [side.table.clone() for _ in range(21)]
        out["k12_ranked_ms"] = timed(
            lambda i: tables[i].lookup_or_insert_ranked(
                h, cr, side.count, is_ins), 20)
    if only is None or "k8" in only:
        k8_times(dev, out)
    if only is None or "k16" in only:
        k16_times(dev, out)
    if only is None or "k18" in only:
        k18_times(dev, out)
    if only is None or "k20" in only:
        k20_times(dev, out)
    print("[compare] " + json.dumps(out), flush=True)
    if "--launches" in sys.argv:
        for q in sys.argv[sys.argv.index("--launches") + 1].split(","):
            print(f"[launches] {root} {q} "
                  + json.dumps(launches_by_kernel(dev, q)), flush=True)
    if "--paths" in sys.argv:
        cs.phase_sharded_main_path(torch, dev, 1, "q5")
        cs.phase_q8_main_path(torch, dev, 1)
    if "--main" in sys.argv:
        for q in sys.argv[sys.argv.index("--main") + 1].split(","):
            if q in cs.TOPN_QUERIES:
                cs.phase_topn_main_path(torch, dev, 1, q)
            elif q in cs.WINDOW_QUERIES:
                cs.phase_window_main_path(torch, dev, 1, q)
            elif q in cs.STRING_QUERIES:
                cs.phase_string_main_path(torch, dev, 1, q)
            else:
                cs.phase_main_path(torch, dev, 1, q)
    return 0


if __name__ == "__main__":
    sys.exit(main())
