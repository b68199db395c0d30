"""Port parity: K23e-h's plain versions (``expr/strings.py``) against the
reference's ``jnp`` functions and against Python.

On ``chip_smoke.k23_rest_cases`` (the rows ``chip_smoke.py`` holds the
kernels to on the card: greedy overlaps, empty patterns, a ``to`` longer
than ``from`` near full rows, patterns longer than the string, bytes past
a quarter of the lengths, strings around spaces, PostgreSQL's
non-positive substr starts and negative counts, timestamps from 1600 to
2400 and dates over +-2^26 days):

- K23e ``str_replace_plain`` against ``_replace`` and ``bytes.replace``
  clamped at the width;
- K23f ``str_match_plain`` against ``_starts_with`` / ``_ends_with`` /
  ``_contains`` and ``bytes.startswith`` / ``endswith`` / ``in``;
  ``like_match_plain`` against ``LikePattern.eval`` and ``re.fullmatch``
  with ``%`` as ``.*``;
- K23g ``str_substr_plain``, ``str_trim_plain`` and ``str_concat_plain``
  against ``_substr_window``, ``_trim_side`` and ``_concat``, and
  Python's slicing, ``strip`` and ``+``;
- K23h ``extract_plain`` against the reference's ``extract_*`` overloads
  over TIMESTAMP and DATE, and ``datetime``.
Tolerance: none — byte and integer arithmetic, compared bit for bit
(bytes past each length included: they must be zero).
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import datetime as dt

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import K23F_LIKE, k23_python_like, k23_rest_cases
from risingwave_tpu.common.chunk import StrCol as JStr
from risingwave_tpu.common.types import DataType as JType
from risingwave_tpu.common.types import Field as JField
from risingwave_tpu.expr import scalar as J
from risingwave_tpu.expr.registry import FUNCTION_REGISTRY as JREG
from risingwave_tpu_torch.common.chunk import StrCol, encode_strings
from risingwave_tpu_torch.expr import strings as S
from risingwave_tpu_torch.expr.scalar import LikePattern

N = 512
CASES = k23_rest_cases(N)


def _pair(name):
    d, ln = CASES[name]
    return (JStr(jnp.asarray(d), jnp.asarray(ln)),
            StrCol(torch.from_numpy(d), torch.from_numpy(ln)))


def _lit(value: bytes, width: int = 64):
    """A literal row broadcast over N rows (stride 0 on the port's side,
    as ``Literal.eval`` gives it)."""
    d, ln = encode_strings([value], width)
    return (JStr(jnp.broadcast_to(jnp.asarray(d[0]), (N, width)),
                 jnp.broadcast_to(jnp.asarray(ln[0]), (N,))),
            StrCol(torch.from_numpy(d).expand(N, -1),
                   torch.from_numpy(ln).expand(N)))


def _rows(name):
    d, ln = CASES[name]
    return [bytes(d[i, :ln[i]]) for i in range(N)]


def _same_str(jout, tout):
    np.testing.assert_array_equal(tout.lens.numpy(), np.asarray(jout.lens))
    np.testing.assert_array_equal(tout.data.numpy(), np.asarray(jout.data))


def _texts(col):
    d, ln = col.data.contiguous().numpy(), col.lens.contiguous().numpy()
    return [bytes(d[i, :ln[i]]) for i in range(d.shape[0])]


def _strings(col):
    """An output's strings; its bytes past each length must be zero."""
    d, ln = col.data.numpy(), col.lens.numpy()
    assert not (d * (np.arange(d.shape[1])[None, :] >= ln[:, None])).any()
    return _texts(col)


REPLACE = {
    "columns": lambda: (_pair("strs"), _pair("frm"), _pair("to")),
    "e to empty": lambda: (_pair("strs"), _lit(b"e"), _lit(b"")),
    "x to yy": lambda: (_pair("strs"), _lit(b"x"), _lit(b"yy")),
    "aa to b": lambda: (_pair("strs"), _lit(b"aa"), _lit(b"b")),
    "empty from": lambda: (_pair("strs"), _lit(b""), _lit(b"Q")),
}


@pytest.mark.parametrize("case", sorted(REPLACE))
def test_replace(case):
    (ja, ta), (jf, tf), (jt, tt) = REPLACE[case]()
    got = S.str_replace_plain(ta, tf, tt)
    _same_str(J._replace(ja, jf, jt), got)
    frm = _strings(tf) if case == "columns" else None
    to = _strings(tt) if case == "columns" else None
    lit_f = bytes(tf.data[0, :tf.lens[0]].numpy())
    lit_t = bytes(tt.data[0, :tt.lens[0]].numpy())
    for i, s in enumerate(_rows("strs")):
        f = frm[i] if frm else lit_f
        t = to[i] if to else lit_t
        want = (s.replace(f, t) if f else s)[:40]
        assert _strings(got)[i] == want, (s, f, t)


@pytest.mark.parametrize("mode", S.MATCH_MODES)
@pytest.mark.parametrize("side", ["columns", "literal", "literal left"])
def test_match_functions(mode, side):
    if side == "columns":
        (ja, ta), (jp, tp) = _pair("strs"), _pair("pats")
    elif side == "literal":
        (ja, ta), (jp, tp) = _pair("strs"), _lit(b"aa")
    else:
        (ja, ta), (jp, tp) = _lit(b"channel=ab"), _pair("pats")
    ref = {"starts_with": J._starts_with, "ends_with": J._ends_with,
           "contains": J._contains}[mode](ja, jp)
    got = S.str_match_plain(ta, tp, mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for i, (s, p) in enumerate(zip(_texts(ta), _texts(tp))):
        want = {"starts_with": s.startswith(p), "ends_with": s.endswith(p),
                "contains": p in s}[mode]
        assert bool(got[i]) == want, (s, p)


class _Col:
    """An expression that evaluates to a fixed column."""

    def __init__(self, col):
        self.col = col

    def eval(self, chunk):
        return self.col


@pytest.mark.parametrize("pattern", K23F_LIKE)
@pytest.mark.parametrize("rows", ["strs", "spaced"])
def test_like(pattern, rows):
    ja, ta = _pair(rows)
    ref = J.LikePattern(_Col(ja), pattern).eval(None)
    node = LikePattern(None, pattern)
    got = S.like_match_plain(ta, node.segs, node.anchor_start,
                             node.anchor_end)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for i, s in enumerate(_rows(rows)):
        assert bool(got[i]) == k23_python_like(s, pattern), (s, pattern)


@pytest.mark.parametrize("rows", ["strs", "spaced"])
@pytest.mark.parametrize("with_count", [False, True])
def test_substr(rows, with_count):
    ja, ta = _pair(rows)
    start, count = CASES["start"], CASES["count"]
    jc = jnp.asarray(count) if with_count else None
    tc = torch.from_numpy(count) if with_count else None
    ref = J._substr_window(ja, jnp.asarray(start), jc)
    got = S.str_substr_plain(ta, torch.from_numpy(start), tc)
    _same_str(ref, got)
    for i, s in enumerate(_rows(rows)):
        lo = max(int(start[i]) - 1, 0)
        hi = len(s) if not with_count else \
            min(int(start[i]) - 1 + max(int(count[i]), 0), len(s))
        assert _strings(got)[i] == (s[lo:hi] if hi > lo else b"")


@pytest.mark.parametrize("mode", ["trim", "ltrim", "rtrim"])
@pytest.mark.parametrize("rows", ["strs", "spaced"])
def test_trim(mode, rows):
    ja, ta = _pair(rows)
    left, right = mode in ("trim", "ltrim"), mode in ("trim", "rtrim")
    _same_str(J._trim_side(ja, left, right), S.str_trim_plain(ta, mode))
    py = {"trim": bytes.strip, "ltrim": bytes.lstrip,
          "rtrim": bytes.rstrip}[mode]
    got = _strings(S.str_trim_plain(ta, mode))
    assert got == [py(s, b" ") for s in _rows(rows)]


@pytest.mark.parametrize("left", ["strs", "literal"])
def test_concat(left):
    (ja, ta) = _pair("strs") if left == "strs" else _lit(b" x")
    jb, tb = _pair("spaced")
    got = S.str_concat_plain(ta, tb)
    _same_str(J._concat(ja, jb), got)
    lhs = _rows("strs") if left == "strs" else [b" x"] * N
    assert _strings(got) == [a + b for a, b in zip(lhs, _rows("spaced"))]


def _python_part(us: int, part: str) -> int:
    t = dt.datetime(1970, 1, 1) + dt.timedelta(microseconds=us)
    return {"year": t.year, "month": t.month, "day": t.day,
            "hour": t.hour, "minute": t.minute, "second": t.second,
            "dow": t.isoweekday() % 7, "doy": t.timetuple().tm_yday,
            "epoch": us // 10**6}[part]


@pytest.mark.parametrize("part", S.EXTRACT_PARTS)
@pytest.mark.parametrize("kind", ["timestamp", "date"])
def test_extract(part, kind):
    x = CASES["ts"] if kind == "timestamp" else CASES["days"]
    jt = JType.TIMESTAMP if kind == "timestamp" else JType.DATE
    f = [JField("x", jt)]
    ref = JREG.resolve(f"extract_{part}", f).call([jnp.asarray(x)], f)
    got = S.extract_plain(torch.from_numpy(x), part, kind == "date")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    us = x.astype(np.int64) * (86_400_000_000 if kind == "date" else 1)
    for i in range(N):
        if -62_135_596_800_000_000 <= us[i] < 253_402_300_800_000_000:
            assert int(got[i]) == _python_part(int(us[i]), part), us[i]
