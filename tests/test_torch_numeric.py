"""Port parity: NUMERIC arithmetic on the path of Nexmark q1.

``0.908 * price`` multiplies a DECIMAL literal (scaled int64) by an
INT64 column promoted to DECIMAL: both sides compute
``round(float64(a) * float64(b) / 10^6)`` with round half to even, in
that order.  The same numpy inputs go through the reference's and the
port's ``multiply`` and ``coerce``.  Tolerance: none — the results are
int64 and must be identical.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.common.types import DataType as JDT, Field as JField
from risingwave_tpu.expr import scalar as jscalar
from risingwave_tpu_torch.common.types import DataType, Field
from risingwave_tpu_torch.expr import scalar as tscalar


def test_numeric_multiply_over_bid_prices():
    """The q1 product over 2^17 prices drawn like Nexmark's (long tail)
    plus the edge values where float64 rounding matters."""
    rng = np.random.default_rng(1)
    n = 1 << 17
    price = np.round(10 ** (rng.random(n) * 6) * 100).astype(np.int64)
    price[:6] = [0, 1, 5, 500, 10**15, -123456789]
    lit = np.full(n, 908_000, np.int64)          # 0.908 at scale 6
    jf = [JField("a", JDT.DECIMAL), JField("b", JDT.INT64)]
    tf = [Field("a", DataType.DECIMAL), Field("b", DataType.INT64)]
    want = np.asarray(jscalar._mul(jnp.asarray(lit), jnp.asarray(price),
                                   fields=jf))
    got = tscalar._mul(torch.from_numpy(lit), torch.from_numpy(price),
                       fields=tf).numpy()
    np.testing.assert_array_equal(got, want)
    # both operands DECIMAL, halves that round to even
    a = rng.integers(-10**9, 10**9, n).astype(np.int64)
    b = rng.integers(-10**7, 10**7, n).astype(np.int64)
    b[:4] = [500_000, 1_500_000, 2_500_000, -500_000]
    a[:4] = 1
    jf2 = [JField("a", JDT.DECIMAL), JField("b", JDT.DECIMAL)]
    tf2 = [Field("a", DataType.DECIMAL), Field("b", DataType.DECIMAL)]
    np.testing.assert_array_equal(
        tscalar._mul(torch.from_numpy(a), torch.from_numpy(b),
                     fields=tf2).numpy(),
        np.asarray(jscalar._mul(jnp.asarray(a), jnp.asarray(b), fields=jf2)))


@pytest.mark.parametrize("scale", [0, 2, 6, 9])
def test_decimal_rescale_to_engine_scale(scale):
    rng = np.random.default_rng(scale)
    v = rng.integers(-10**12, 10**12, 1000).astype(np.int64)
    want = np.asarray(jscalar.coerce(
        jnp.asarray(v), JField("d", JDT.DECIMAL, decimal_scale=scale),
        JDT.DECIMAL))
    got = tscalar.coerce(torch.from_numpy(v),
                         Field("d", DataType.DECIMAL, decimal_scale=scale),
                         DataType.DECIMAL).numpy()
    np.testing.assert_array_equal(got, want)
