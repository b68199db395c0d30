"""Port parity on the corner cases of the top-N flush's band diff (K18)
and of the over-window's flush (K20).

K18's kernels gather the band in words, count each hash run's live
entries with a grid scan (decoupled look-back) and decide the rank-aware
membership by merging the two sorted sides; K20's scan every window lane
with a look-back and finish each emitted row in words.  These cases are
the ones such a redesign could get wrong.  Each is built from a numpy seed
(``chip_smoke.k18_cases``, ``chip_smoke.k20_cases``, which the card runs
too, where the tile edges are the kernels') and goes through the
reference's flush and the port's plain version, which ``chip_smoke.py``
holds the kernels against on the card:

- K18: ``GroupTopNExecutor.flush`` on a crafted state (equal hashes on
  both sides with more live copies on either, live entries hashing to 0,
  an all-dead side, an all-equal side, a rank column and none, strings of
  3, 16 and 40 bytes, E off the kernels' tiles): the out chunk and every
  state tensor;
- K20: ``OverWindowExecutor.flush`` with every call kind on pools whose
  segments start on tile edges or span several tiles, lag/lead and ROWS
  frames across tiles, E > S and S > E (the overflow gauge), strings of 3,
  16, 40 and 64 bytes and ties on the order key: two flushes, the second
  after validity flips.

Tolerance: none (integers and copied bytes; the float sums are of dyadic
values, so every partial sum is exact).
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.common.chunk import StrCol as JStrCol
from risingwave_tpu.common.types import (
    DataType as JDT,
    Field as JField,
    Schema as JSchema,
)
from risingwave_tpu.expr.node import InputRef as JRef
from risingwave_tpu.stream import over_window as jow
from risingwave_tpu.stream import top_n as jtop_n
from risingwave_tpu_torch.compat import state_mismatches

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the cases, shared with the card's phases)

CPU = torch.device("cpu")


def _j_col(c):
    if isinstance(c, tuple):
        return JStrCol(jnp.asarray(c[0]), jnp.asarray(c[1]))
    return jnp.asarray(c)


def _j_schema(fields):
    return JSchema(tuple(JField(n, getattr(JDT, t), str_width=w or 16)
                         for n, t, w in fields))


def _assert_chunks(jout, tout, tag):
    np.testing.assert_array_equal(np.asarray(jout.ops), tout.ops.numpy())
    np.testing.assert_array_equal(np.asarray(jout.valid), tout.valid.numpy(),
                                  err_msg=f"{tag} valid")
    for j, (a, b) in enumerate(zip(jout.columns, tout.columns)):
        if isinstance(a, JStrCol):
            np.testing.assert_array_equal(np.asarray(a.data), b.data.numpy(),
                                          err_msg=f"{tag} column {j} bytes")
            np.testing.assert_array_equal(np.asarray(a.lens), b.lens.numpy(),
                                          err_msg=f"{tag} column {j} lens")
        else:
            a, b = np.asarray(a), b.numpy()
            if a.dtype.kind == "f":  # copied floats: bit for bit
                a, b = a.view(np.int64), b.view(np.int64)
            np.testing.assert_array_equal(a, b, err_msg=f"{tag} column {j}")


# ---------------------------------------------------------------------------
# K18: GroupTopNExecutor.flush


K18_CASES = {c["name"]: c for c in chip_smoke.k18_cases()}


def _j_topn(case):
    S, E = case["S"], case["E"]
    jex = jtop_n.GroupTopNExecutor(
        _j_schema(chip_smoke.K18_FIELDS), [], [(JRef(0), False)], S,
        pool_size=S, emit_capacity=E,
        rank_alias="rn" if case["rank"] else None)
    jst = jex.init_state()._replace(
        rows=tuple(_j_col(c) for c in case["rows"]),
        valid=jnp.asarray(case["valid"]),
        row_hash=jnp.asarray(case["row_hash"].view(np.uint64)),
        prev_rows=tuple(_j_col(c) for c in case["prev_rows"]),
        prev_valid=jnp.asarray(case["prev_valid"]),
        prev_hash=jnp.asarray(case["prev_hash"].view(np.uint64)))
    return jex, jst


@pytest.mark.parametrize("name", sorted(K18_CASES))
def test_band_diff_case(name):
    case = K18_CASES[name]
    jex, jst = _j_topn(case)
    tex, tst = chip_smoke.k18_torch_case(torch, case, CPU)
    assert state_mismatches(jax.device_get(jst), tst) == []
    jst, jout = jax.jit(jex.flush)(jst, 0)
    tst, tout = tex.flush(tst, 0)
    _assert_chunks(jout, tout, name)
    assert state_mismatches(jax.device_get(jst), tst) == []


def _runs(h, live):
    """{hash: live count} of one side."""
    vals, counts = np.unique(h[live], return_counts=True)
    return dict(zip(vals.tolist(), counts.tolist()))


def test_k18_cases_cover_the_corners():
    """The cases hold what the kernels' design must get right: a hash with
    more live copies on each side, live entries hashing to 0 on both, an
    all-dead side of each kind, an all-equal side of E live entries, a
    rank column and none, strings of 3, 16 and 40 bytes, and E past one
    tile (512) and off it."""
    seen = set()
    for case in K18_CASES.values():
        tex, tst = chip_smoke.k18_torch_case(torch, case, CPU)
        new, _ = tex.flush(tst, 0)
        nh, nl = new.prev_hash.numpy(), new.prev_valid.numpy()
        ph, pl = case["prev_hash"], case["prev_valid"]
        a, b = _runs(nh, nl), _runs(ph, pl)
        shared = set(a) & set(b)
        if any(a[h] > b[h] for h in shared):
            seen.add("more new")
        if any(b[h] > a[h] for h in shared):
            seen.add("more old")
        if (nl & (nh == 0)).any() and (pl & (ph == 0)).any():
            seen.add("live zero")
        if not pl.any():
            seen.add("old dead")
        if not nl.any():
            seen.add("new dead")
        if nl.all() and len(a) == 1:
            seen.add("all equal")
        seen.add(f"rank {case['rank']}")
        if case["E"] > 512 and case["E"] % 512:
            seen.add("wide")
    assert seen == {"more new", "more old", "live zero", "old dead",
                    "new dead", "all equal", "rank True", "rank False",
                    "wide"}
    widths = {w for _, kind, w in chip_smoke.K18_FIELDS if kind == "VARCHAR"}
    assert widths == {3, 16, 40}


# ---------------------------------------------------------------------------
# K20: OverWindowExecutor.flush


K20_CASES = {c["name"]: c for c in chip_smoke.k20_cases()}


def _j_window(case):
    calls = [jow.WindowFuncCall(kind, None if arg is None else JRef(arg),
                                off, alias, frame=frame)
             for kind, arg, off, alias, frame in chip_smoke.K20_CALLS]
    jex = jow.OverWindowExecutor(
        _j_schema(chip_smoke.K20_FIELDS), [JRef(0)], [(JRef(1), False)],
        calls, pool_size=case["S"], emit_capacity=case["E"])
    jst = jex.init_state()._replace(
        rows=tuple(_j_col(c) for c in case["rows"]),
        valid=jnp.asarray(case["valid"]))
    return jex, jst


@pytest.mark.parametrize("name", sorted(K20_CASES))
def test_over_window_case(name):
    """Two flushes, the second after validity flips: equal out chunks and
    every state tensor (the emitted rows, dead ones included, their
    hashes and the overflow gauge)."""
    case = K20_CASES[name]
    jex, jst = _j_window(case)
    tex, tst = chip_smoke.k20_torch_case(torch, case, CPU)
    flip = case["flip"]
    flush = jax.jit(jex.flush)  # the reference's flush runs eagerly
    for step in range(2):
        jst, jout = flush(jst, step)
        tst, tout = tex.flush(tst, step)
        _assert_chunks(jout, tout, f"{name} flush {step}")
        assert state_mismatches(jax.device_get(jst), tst) == []
        jst = jst._replace(valid=jst.valid ^ jnp.asarray(flip))
        tst.valid.logical_xor_(torch.from_numpy(flip))


def test_k20_cases_cover_the_corners():
    """A segment starting exactly on a scan tile's edge (512), a segment
    over three tiles, E > S, S > E with valid rows past E, ties on the
    order key, strings of 3, 16, 40 and 64 bytes, and lag/lead and a ROWS
    frame reaching an earlier tile."""
    seen = set()
    for case in K20_CASES.values():
        tex, tst = chip_smoke.k20_torch_case(torch, case, CPU)
        order, valid_s, outs = tex._compute_outputs(tst)
        S, E = case["S"], case["E"]
        P = min(S, E)
        rn = outs[0].numpy()[:P]
        starts = np.flatnonzero(rn == 1)
        if any(s and s % 512 == 0 for s in starts):
            seen.add("edge start")
        if np.diff(np.append(starts, P)).max() > 1024:
            seen.add("three tiles")
        if E > S:
            seen.add("E > S")
        if S > E and int(valid_s.sum()) > E:
            seen.add("overflow")
        rk, dr = outs[1].numpy()[:P], outs[2].numpy()[:P]
        if (rk != rn).any() and (dr != rk).any():
            seen.add("ties")
    assert seen == {"edge start", "three tiles", "E > S", "overflow",
                    "ties"}
    widths = {w for _, kind, w in chip_smoke.K20_FIELDS if kind == "VARCHAR"}
    assert widths == {3, 16, 40, 64}
    reach = [off for kind, _, off, _, _ in chip_smoke.K20_CALLS
             if kind in ("lag", "lead")]
    frames = [f[0] for *_, f in chip_smoke.K20_CALLS if f is not None]
    assert max(reach) > 512 and max(frames) > 512
