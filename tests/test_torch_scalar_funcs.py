"""Port parity: the scalar-function registry (``expr/scalar.py``).

The port's ``FUNCTION_REGISTRY`` must hold the reference's overloads,
name by name in the same order (resolution breaks score ties by it), with
the same return types and null handling.  Every overload this slice
ported runs on the same numpy-seeded columns through the reference's
implementation (``jnp`` on the CPU) and the port's (torch on the CPU:
K23d-h's plain versions for the strings and the calendar), parametrised
by function and argument types; the casts run across the whole type
matrix (NaN, infinities and out-of-range floats included: XLA converts
float to int saturating); ``divide``'s three branches run with zero
divisors.

Tolerance: exact (bit for bit, NaN where NaN) everywhere except the
reference's ``sqrt``, ``exp``, ``ln``, ``log10`` and ``power``: XLA's
CPU implementations of them are not correctly rounded (``sqrt`` is off by
one ULP on some inputs), and torch's are libm's, so these are held to 4
ULP (``rtol`` 1e-15).
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import itertools
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.common.chunk import StrCol as JStr
from risingwave_tpu.common.types import DataType as JType
from risingwave_tpu.common.types import Field as JField
from risingwave_tpu.expr import scalar as jscalar  # noqa: F401 registers
from risingwave_tpu.expr.registry import FUNCTION_REGISTRY as JREG
from risingwave_tpu_torch.common.chunk import StrCol, encode_strings
from risingwave_tpu_torch.common.types import DataType, Field
from risingwave_tpu_torch.expr import scalar  # noqa: F401 registers
from risingwave_tpu_torch.expr.registry import FUNCTION_REGISTRY

N = 48
#: the overloads this slice ported (everything else was ported before)
NEW = ("abs", "round", "floor", "ceil", "sign", "sqrt", "power", "exp",
       "ln", "log10", "greatest", "least", "char_length", "octet_length",
       "length", "concat", "substr", "trim", "ltrim", "rtrim",
       "starts_with", "ends_with", "contains", "replace", "extract_year",
       "extract_month", "extract_day", "extract_hour", "extract_minute",
       "extract_second", "extract_dow", "extract_doy", "extract_epoch",
       "date_trunc_second", "date_trunc_minute", "date_trunc_hour",
       "date_trunc_day")
#: the reference's libm-like functions held to 4 ULP (module docstring)
APPROX = {"sqrt", "exp", "ln", "log10", "power"}
#: one concrete type per family token, plus the pairs of a two-argument
#: numeric family (every type with itself, and mixed widths)
FAMILY = {
    "numeric": ("int16", "int32", "int64", "float32", "float64", "decimal"),
    "floatlike": ("float32", "float64"),
    "stringlike": ("varchar",),
}
NUM_PAIRS = [(t, t) for t in FAMILY["numeric"]] + [
    ("int32", "int64"), ("int64", "decimal"), ("decimal", "float64"),
    ("int16", "float32"), ("float32", "float64"), ("decimal", "int32")]
CASTS = ("int16", "int32", "int64", "float32", "float64", "decimal",
         "boolean", "timestamp", "timestamptz", "date")


def _sig_key(s):
    return (tuple(tok for tok, _ in s.arg_matchers), s.ret, s.null_aware,
            s.never_null, s.takes_fields)


def test_registry_holds_every_reference_overload():
    """The two registries, overload by overload, in registration order:
    the diff is empty."""
    ref = {n: [_sig_key(s) for s in v] for n, v in JREG._by_name.items()}
    port = {n: [_sig_key(s) for s in v]
            for n, v in FUNCTION_REGISTRY._by_name.items()}
    assert sorted(set(ref) ^ set(port)) == []
    assert {n: ref[n] for n in ref if ref[n] != port[n]} == {}
    assert len(FUNCTION_REGISTRY) == len(JREG)


def _dtype(name: str) -> DataType:
    """A type by its enum name, or by a signature's SQL token."""
    return {"int": DataType.INT32, "bigint": DataType.INT64}.get(
        name, None) or DataType[name.upper()]


def _values(t: DataType, rng, fn: str = ""):
    """numpy values of logical type ``t`` (strings: (bytes, lens))."""
    n = N
    if t.is_string:
        words = (b"", b" ", b"  ab ", b"aaa", b"ab/ab/", b"https://e.io/e",
                 b"eee", b"x y", b"\xff\x80", b"q" * 16)
        picks = [words[k] + words[j][:5] for k, j in
                 zip(rng.integers(0, len(words), n),
                     rng.integers(0, len(words), n))]
        return encode_strings(picks, 16)
    if t == DataType.BOOLEAN:
        return rng.random(n) < 0.5
    if t == DataType.DATE:
        return rng.integers(-200_000, 200_000, n).astype(np.int32)
    if t in (DataType.TIMESTAMP, DataType.TIMESTAMPTZ):
        v = rng.integers(-11_676_096_000_000_000, 13_569_465_600_000_000, n)
        v[:3] = (0, -1, 86_400_000_000)
        return v.astype(np.int64)
    if t == DataType.DECIMAL:
        v = rng.integers(-10**12, 10**12, n)
        v[:6] = (0, 500_000, -500_000, 1_500_000, -2_500_000, 1)
        return v.astype(np.int64)
    if t.physical_dtype.is_floating_point:
        dt = np.float32 if t == DataType.FLOAT32 else np.float64
        v = rng.normal(0, 1e3, n)
        v[:8] = (0.5, -2.5, 2.5, 0.0, -0.0, 1e-3, 3.0, 123.456)
        if fn.startswith("cast_") or fn in ("abs", "sign", "greatest",
                                            "least", "floor", "ceil",
                                            "round"):
            v[8:14] = (np.nan, np.inf, -np.inf, 1e20, -1e20, 3e9)
        if fn in ("ln", "log10", "sqrt"):
            v = np.abs(v)
        return v.astype(dt)
    info = np.iinfo({DataType.INT16: np.int16, DataType.INT32: np.int32,
                     DataType.INT64: np.int64}[t])
    lim = min(info.max, 10**6)
    v = rng.integers(-lim, lim, n)
    if fn in ("power", "exp"):
        v = rng.integers(-6, 7, n)
    if fn in ("round",):
        v = rng.integers(-8, 8, n)
    v[:3] = (0, 1, -1)
    return v.astype(info.dtype)


def _cols(types, rng, fn):
    j, t = [], []
    for ty in types:
        v = _values(ty, rng, fn)
        if isinstance(v, tuple):
            j.append(JStr(jnp.asarray(v[0]), jnp.asarray(v[1])))
            t.append(StrCol(torch.from_numpy(v[0]), torch.from_numpy(v[1])))
        else:
            j.append(jnp.asarray(v))
            t.append(torch.from_numpy(np.ascontiguousarray(v)))
    return j, t


def _fields(types):
    return ([JField(f"a{i}", JType[t.name]) for i, t in enumerate(types)],
            [Field(f"a{i}", t) for i, t in enumerate(types)])


def _assert_equal(name, jout, tout, approx=False):
    if isinstance(jout, JStr):
        assert isinstance(tout, StrCol)
        np.testing.assert_array_equal(tout.lens.numpy(), np.asarray(jout.lens))
        np.testing.assert_array_equal(tout.data.numpy(), np.asarray(jout.data))
        return
    j = np.asarray(jout)
    t = tout.numpy()
    assert t.dtype == j.dtype, (name, t.dtype, j.dtype)
    if approx:
        np.testing.assert_allclose(t, j, rtol=1e-15, atol=0)
    else:
        np.testing.assert_array_equal(t, j)


def _call(name, types, seed):
    rng = np.random.default_rng(seed)
    jc, tc = _cols(types, rng, name)
    jf, tf = _fields(types)
    jout = JREG.resolve(name, jf).call(jc, jf)
    tout = FUNCTION_REGISTRY.resolve(name, tf).call(tc, tf)
    return jout, tout


def _overload_cases():
    cases = []
    for name in NEW:
        for sig in FUNCTION_REGISTRY._by_name[name]:
            toks = [tok for tok, _ in sig.arg_matchers]
            if toks == ["numeric", "numeric"]:
                combos = NUM_PAIRS
            else:
                combos = itertools.product(*(FAMILY.get(t, (t,))
                                             for t in toks))
            for combo in combos:
                cases.append(pytest.param(
                    name, combo, id=f"{name}({','.join(combo)})"))
    return cases


@pytest.mark.parametrize("name,types", _overload_cases())
def test_new_overload_matches_reference(name, types):
    types = [_dtype(t) for t in types]
    jout, tout = _call(name, types, seed=zlib.crc32(name.encode()) % 1000)
    _assert_equal(name, jout, tout, approx=name in APPROX)


@pytest.mark.parametrize("src", CASTS + ("varchar",))
def test_casts_across_the_type_matrix(src):
    """Every cast target from ``src``; a string source raises in both."""
    for dst in CASTS:
        name = f"cast_{_dtype(dst).name.lower()}"
        st = _dtype(src)
        if st.is_string or (st == DataType.DECIMAL
                            and _dtype(dst) == DataType.BOOLEAN):
            with pytest.raises(TypeError):
                _call(name, [st], seed=7)
            with pytest.raises(TypeError):
                rng = np.random.default_rng(7)
                _, tc = _cols([st], rng, name)
                _, tf = _fields([st])
                FUNCTION_REGISTRY.resolve(name, tf).call(tc, tf)
            continue
        jout, tout = _call(name, [st], seed=7)
        _assert_equal(name, jout, tout)


@pytest.mark.parametrize("types", [("int64", "int32"), ("int32", "int32"),
                                   ("float64", "int32"),
                                   ("float32", "float32"),
                                   ("decimal", "int32"),
                                   ("decimal", "decimal"),
                                   ("int64", "decimal")])
def test_divide_branches_with_zero_divisors(types):
    """NUMERIC through float64 rounded at the engine scale (0 for a zero
    divisor), float IEEE (inf and NaN for zero), integer floor (0)."""
    types = [_dtype(t) for t in types]
    rng = np.random.default_rng(11)
    jc, tc = _cols(types, rng, "divide")
    b = np.asarray(jc[1]).copy()
    b[::5] = 0
    jc[1] = jnp.asarray(b)
    tc[1] = torch.from_numpy(b)
    jf, tf = _fields(types)
    jout = JREG.resolve("divide", jf).call(jc, jf)
    tout = FUNCTION_REGISTRY.resolve("divide", tf).call(tc, tf)
    _assert_equal("divide", jout, tout)
