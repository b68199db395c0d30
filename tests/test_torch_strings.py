"""Port parity: the string and calendar kernels K23a-d (their plain
versions) against the reference's functions.

The same seeded numpy inputs (``chip_smoke.k23_cases``: the hand-picked
edge cases first, then random token strings, a quarter of the rows with
non-zero bytes past their length; per-row delimiters and part numbers;
timestamps over +-400 years with the day and noon boundaries, years 0,
-1, 9999 and 10000 and the int64 extremes) go through the reference's
``_cmp_strs`` comparisons, ``_lower``/``_upper``, ``_split_part``,
``eval_to_char`` and ``RegexpGroup`` and through the port's plain
versions (``expr/strings.py``) and nodes (``expr/scalar.py``).  Bytes
(zero tails included), lengths and null planes must be equal; the split
and the regexp capture also equal Python's ``bytes.split`` and ``re``,
and to_char Python's ``strftime`` where ``datetime`` reaches.
Tolerance: none — the functions are byte and integer arithmetic.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import datetime as dt
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import k23_cases, k23_python_split
from risingwave_tpu.common.chunk import Chunk as JChunk
from risingwave_tpu.common.chunk import NCol as JNCol
from risingwave_tpu.common.chunk import StrCol as JStrCol
from risingwave_tpu.common.types import DataType as JDT
from risingwave_tpu.common.types import Field as JField
from risingwave_tpu.common.types import Schema as JSchema
from risingwave_tpu.expr import scalar as jscalar
from risingwave_tpu.expr.node import InputRef as JInputRef
from risingwave_tpu.expr.registry import FUNCTION_REGISTRY as JREG
from risingwave_tpu_torch.common.chunk import (
    Chunk,
    NCol,
    StrCol,
    encode_strings,
)
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.expr import scalar, strings
from risingwave_tpu_torch.expr.node import InputRef, Literal

N = 256
CASES = k23_cases(N)
OPS = dict(zip(strings.CMP_OPS, ("equal", "not_equal", "less_than",
                                 "less_than_or_equal", "greater_than",
                                 "greater_than_or_equal")))
FORMATS = ("YYYY-MM-DD", "HH:MI", "HH24:MI:SS.MS", "yy/mm/dd US",
           "hh12 am PM", "yyyy-mm-dd hh24:mi:ss.us pm", "abc", "Y-D")
PATTERNS = ("(&|^)channel_id=([^&]*)", "(^|&)channel_id=([^&]*)",
            "channel_id=([^&]*)", "(&|^)a([^/]*)", "(&|^)x([^=]*)")


def _pair(arrays):
    data, lens = arrays
    return (JStrCol(jnp.asarray(data), jnp.asarray(lens)),
            StrCol(torch.from_numpy(data.copy()),
                   torch.from_numpy(lens.copy())))


def _literal(value: str, width: int = 64):
    """A literal column of both packages (the port's a stride-0 row)."""
    b = value.encode()
    data = np.zeros((1, width), np.uint8)
    data[0, :len(b)] = np.frombuffer(b, np.uint8)
    lens = np.array([len(b)], np.int32)
    return (JStrCol(jnp.broadcast_to(jnp.asarray(data), (N, width)),
                    jnp.broadcast_to(jnp.asarray(lens), (N,))),
            StrCol(torch.from_numpy(data).expand(N, -1),
                   torch.from_numpy(lens).expand(N)))


def _same_str(ref, port):
    np.testing.assert_array_equal(np.asarray(ref.data), port.data.numpy())
    np.testing.assert_array_equal(np.asarray(ref.lens), port.lens.numpy())


def _decoded(col: StrCol) -> list[bytes]:
    d, ln = col.data.numpy(), col.lens.numpy()
    return [bytes(d[i, :ln[i]]) for i in range(len(ln))]


@pytest.mark.parametrize("op", strings.CMP_OPS)
def test_str_cmp_matches_reference(op):
    """The six comparisons over columns (copies, prefixes, extensions,
    random; bytes >= 128; garbage past the lengths) and with a literal on
    either side."""
    a, b = _pair(CASES["strs"]), _pair(CASES["other"])
    lit_r, lit_l = _literal("channel_id=abc"), _literal("aa")
    sig = JREG.resolve(OPS[op], [JField("a", JDT.VARCHAR)] * 2)
    for (ja, ta), (jb, tb) in ((a, b), (a, lit_r), (lit_l, a), (b, a)):
        want = np.asarray(sig.impl(ja, jb))
        np.testing.assert_array_equal(strings.str_cmp_plain(ta, tb, op)
                                      .numpy(), want)
        np.testing.assert_array_equal(strings.str_cmp(ta, tb, op).numpy(),
                                      want)


def test_str_cmp_orders_like_python_bytes():
    a, b = _pair(CASES["strs"])[1], _pair(CASES["other"])[1]
    want = [x < y for x, y in zip(_decoded(a), _decoded(b))]
    assert strings.str_cmp_plain(a, b, "lt").tolist() == want


@pytest.mark.parametrize("upper", [False, True])
def test_case_map_matches_reference(upper):
    """Every byte of the width is mapped (the garbage past the lengths
    too, as the reference's whole-array ``where``)."""
    j, t = _pair(CASES["strs"])
    ref = (jscalar._upper if upper else jscalar._lower)(j)
    _same_str(ref, strings.str_case_map_plain(t, upper))
    _same_str(ref, strings.str_case_map(t, upper))


def test_split_part_per_row_delimiters_and_n():
    """Per-row delimiters (empty, overlapping 'aa', 3-byte, full width)
    and n (0, +-7, past the part count both ways, the int32 extremes)."""
    ja, ta = _pair(CASES["strs"])
    jd, td = _pair(CASES["delims"])
    nth = CASES["nth"]
    ref = jscalar._split_part(ja, jd, jnp.asarray(nth))
    got = strings.str_split_part_plain(ta, td, torch.from_numpy(nth))
    _same_str(ref, got)
    sd, sl = CASES["strs"]
    dd, dl = CASES["delims"]
    want = [k23_python_split(bytes(sd[i, :sl[i]]), bytes(dd[i, :dl[i]]),
                             int(nth[i])) for i in range(N)]
    assert _decoded(got) == want


@pytest.mark.parametrize("n", [4, 5, 6, 1, -1, -3, 40, -40])
def test_split_part_literal_delimiter(n):
    """q22's shape: a column split by a stride-0 literal '/' at a
    literal n."""
    ja, ta = _pair(CASES["strs"])
    jd, td = _literal("/")
    ref = jscalar._split_part(ja, jd, jnp.full((N,), n, jnp.int32))
    got = strings.str_split_part(ta, td, torch.full((N,), n,
                                                    dtype=torch.int32))
    _same_str(ref, got)


def test_split_part_greedy_examples():
    """'aa' in 'aaaa' is two matches (three empty parts), in 'aaa' one;
    an empty delimiter leaves the string whole."""
    rows = [("aaaa", "aa", 1), ("aaaa", "aa", 3), ("aaaa", "aa", 4),
            ("aaa", "aa", 2), ("aaa", "aa", -1), ("abc", "", 1),
            ("abc", "", -1), ("abc", "", 2), ("/a//b/", "/", -2),
            ("a/b", "/", -3)]
    want = [b"", b"", b"", b"a", b"a", b"abc", b"abc", b"", b"b", b""]
    strs, delims, nth = zip(*rows)
    s, d = (StrCol(*map(torch.from_numpy, encode_strings(col, 8)))
            for col in (strs, delims))
    n = torch.tensor(nth, dtype=torch.int32)
    assert _decoded(strings.str_split_part_plain(s, d, n)) == want


@pytest.mark.parametrize("fmt", FORMATS)
def test_to_char_matches_reference(fmt):
    """Floor semantics before 1970, years past 9999 (the low 4 digits)
    and below 0, the 12-hour clock and AM/PM at the noon boundary."""
    segs = scalar.compile_to_char_pattern(fmt)
    assert segs == jscalar.compile_to_char_pattern(fmt)
    ts = CASES["ts"]
    ref = jscalar.eval_to_char(jnp.asarray(ts), segs)
    got = strings.to_char_plain(torch.from_numpy(ts), segs)
    _same_str(ref, got)
    _same_str(ref, strings.to_char(torch.from_numpy(ts), segs))


def test_to_char_equals_strftime():
    """Where Python's datetime reaches (years 1-9999): q10's two
    formats against strftime."""
    ts = CASES["ts"]
    lo = (dt.datetime(1, 1, 1) - dt.datetime(1970, 1, 1)) \
        // dt.timedelta(microseconds=1)
    hi = (dt.datetime(9999, 12, 31, 23, 59, 59, 999999)
          - dt.datetime(1970, 1, 1)) // dt.timedelta(microseconds=1)
    ts = ts[(ts >= lo) & (ts <= hi)]
    for fmt, py in (("YYYY-MM-DD", "%Y-%m-%d"), ("HH:MI", "%I:%M"),
                    ("HH24:MI:SS.US", "%H:%M:%S.%f")):
        got = _decoded(strings.to_char_plain(
            torch.from_numpy(ts), scalar.compile_to_char_pattern(fmt)))
        want = [(dt.datetime(1970, 1, 1) + dt.timedelta(microseconds=int(t)))
                .strftime(py).encode() for t in ts]
        want = [w.rjust(10, b"0") if fmt == "YYYY-MM-DD" else w for w in want]
        assert got == want, fmt


def test_to_char_program_layout():
    """K23b's segment program: component codes, literal offsets, width;
    a format beyond its fixed size is refused."""
    prog = strings.to_char_program(tuple(
        scalar.compile_to_char_pattern("YYYY-MM-DD HH:MI am")))
    assert prog.n == 11 and prog.width == 19
    assert list(prog.kind[:prog.n]) == [1, 0, 3, 0, 4, 0, 6, 0, 7, 0, 12]
    assert list(prog.arg[:prog.n]) == [4, 0, 2, 1, 2, 2, 2, 3, 2, 4, 2]
    assert bytes(prog.lit[:5]) == b"-- : "
    with pytest.raises(ValueError):
        strings.to_char_program(tuple(
            scalar.compile_to_char_pattern("YYYY." * 20)))


def _chunks(arrays, null):
    """One nullable VARCHAR column of both packages as a chunk."""
    data, lens = arrays
    jf = JField("s", JDT.VARCHAR, str_width=data.shape[1], nullable=True)
    f = Field("s", DataType.VARCHAR, str_width=data.shape[1], nullable=True)
    jc = JChunk((JNCol(JStrCol(jnp.asarray(data), jnp.asarray(lens)),
                       jnp.asarray(null)),),
                jnp.zeros(N, jnp.int8), jnp.ones(N, bool), JSchema((jf,)))
    tc = Chunk((NCol(StrCol(torch.from_numpy(data.copy()),
                            torch.from_numpy(lens.copy())),
                     torch.from_numpy(null.copy())),),
               torch.zeros(N, dtype=torch.int8),
               torch.ones(N, dtype=torch.bool), Schema((f,)))
    return jc, tc


@pytest.mark.parametrize("pattern", PATTERNS)
def test_regexp_group_matches_reference(pattern):
    """The capture, its length and its NULL (unmatched or a NULL input)
    on the guard at 0, after '&', failing after another byte, unguarded
    (not anchored), empty captures, captures to the end."""
    null = np.random.default_rng(5).random(N) < 0.1
    jc, tc = _chunks(CASES["strs"], null)
    ref = jscalar.RegexpGroup(JInputRef(0), pattern, 2).eval(jc)
    node = scalar.RegexpGroup(InputRef(0), pattern, 2)
    got = node.eval(tc)
    _same_str(ref.data, got.data)
    np.testing.assert_array_equal(np.asarray(ref.null), got.null.numpy())
    assert got.null.numpy().sum() < N  # some rows match
    # Python's re on the rows' bytes: the same captures
    sd, sl = CASES["strs"]
    rx = re.compile(pattern.encode())
    for i in range(N):
        m = rx.search(bytes(sd[i, :sl[i]]))
        want = None if (m is None or null[i]) else m.group(rx.groups)
        have = None if got.null[i] else bytes(
            got.data.data[i, :got.data.lens[i]].numpy())
        assert have == want, (i, bytes(sd[i, :sl[i]]))


def test_literal_is_one_cached_row():
    """A VARCHAR literal is encoded and uploaded once per device and
    evaluates to a stride-0 view of that row: every chunk row reads it."""
    lit = Literal("apple", DataType.VARCHAR)
    chunk = Chunk((torch.zeros(N, dtype=torch.int64),),
                  torch.zeros(N, dtype=torch.int8),
                  torch.ones(N, dtype=torch.bool),
                  Schema((Field("x", DataType.INT64),)))
    a, b = lit.eval(chunk), lit.eval(chunk)
    assert a.data.data_ptr() == b.data.data_ptr()
    assert a.data.stride(0) == 0 and a.lens.stride(0) == 0
    assert a.data.shape == (N, 64) and _decoded(a) == [b"apple"] * N
