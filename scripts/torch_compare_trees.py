"""Time K5 and K12 ranked, and the q5-sharded and q8 paths, of one
checkout of the PyTorch port on the card.

    python3 scripts/torch_compare_trees.py ROOT [--paths]

ROOT is the root of a checkout (its ``chip_smoke.py`` and
``risingwave_tpu_torch`` are imported from there, its kernels built under
ROOT/build/kernels).  To compare two commits on one card, unpack the other
one with ``git archive`` into a directory that ``.gitignore`` lists and run
this in turns from both, in one call: parent, change, change, parent.
Kernel times are device times (CUDA events over calls queued behind a
sleep); ``--paths`` adds chip_smoke's q5-sharded and q8 main paths of
ROOT (their rows/s and profiled windows).  Prints one ``[compare]`` JSON
line; needs a card.
"""

import json
import sys

root = sys.argv[1]
sys.path.insert(0, root)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from risingwave_tpu_torch.common.hash import hash64_columns  # noqa: E402
from risingwave_tpu_torch.common.tree import tree_map  # noqa: E402
from risingwave_tpu_torch.stream import hash_agg as ha  # noqa: E402
from risingwave_tpu_torch.stream import hash_join as hj  # noqa: E402


def timed(fn, iters: int) -> float:
    """Device ms a call of ``fn(i)`` over ``iters`` calls."""
    fn(iters)
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(min(iters * 1.0, 200.0) * cs.CYCLES_PER_MS))
    e0.record()
    for i in range(iters):
        fn(i)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_compare_trees: no card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    out = {"tree": root, "card": torch.cuda.get_device_name(0)}
    pane, lane = k5_pane(dev), k5_lane(dev)
    out["k5_pane_ms"] = timed(lambda i: ha.agg_preagg_cuda(*pane), 200)
    out["k5_lane_ms"] = timed(lambda i: ha.agg_preagg_cuda(*lane), 20)
    side, h, cr, is_ins = k12_q8(dev)
    tables = [side.table.clone() for _ in range(21)]
    out["k12_ranked_ms"] = timed(lambda i: tables[i].lookup_or_insert_ranked(
        h, cr, side.count, is_ins), 20)
    print("[compare] " + json.dumps(out), flush=True)
    if "--paths" in sys.argv:
        cs.phase_sharded_main_path(torch, dev, 1, "q5")
        cs.phase_q8_main_path(torch, dev, 1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
