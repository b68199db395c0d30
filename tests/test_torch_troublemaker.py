"""Port parity: the troublemaker (K28's plain version).

``TroublemakerExecutor.apply`` against the reference's over several
chunks, seeds and ratios (ratio 3 and 5: the modulo is taken on the
unsigned hash), ops and state; and ``tests/test_ctl.py``'s scenario on
the port: the corrupted stream hits a hash-join side, whose
``inconsistency`` counter rises, as the reference's does.  Tolerance:
none.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.common.chunk import Chunk as JChunk
from risingwave_tpu.common.types import DataType as JType
from risingwave_tpu.common.types import Schema as JSchema
from risingwave_tpu.stream.troublemaker import (
    TroublemakerExecutor as JTroublemaker,
)
from risingwave_tpu_torch.common.chunk import Chunk
from risingwave_tpu_torch.common.types import DataType, Schema
from risingwave_tpu_torch.stream.troublemaker import TroublemakerExecutor


@pytest.mark.parametrize("seed,ratio", [(7, 4), (0, 3), (123456789, 16),
                                        (2**64 - 1, 5), (42, 1)])
def test_troublemaker_matches_reference(seed, ratio):
    rng = np.random.default_rng(seed % 1000 + ratio)
    jt = JTroublemaker(JSchema.of(("k", JType.INT64)), seed=seed,
                       ratio=ratio)
    tt = TroublemakerExecutor(Schema.of(("k", DataType.INT64)), seed=seed,
                              ratio=ratio)
    jst, tst = jt.init_state(), tt.init_state("cpu")
    flipped = 0
    for cap in (64, 256, 64, 128, 64):
        k = np.arange(cap, dtype=np.int64)
        ops = rng.integers(0, 4, cap).astype(np.int8)
        valid = rng.random(cap) < 0.85
        jst, jout = jt.apply(jst, JChunk(
            (jnp.asarray(k),), jnp.asarray(ops), jnp.asarray(valid),
            jt.in_schema))
        tst, tout = tt.apply(tst, Chunk(
            (torch.from_numpy(k),), torch.from_numpy(ops),
            torch.from_numpy(valid), tt.in_schema))
        assert np.array_equal(tout.ops.numpy(), np.asarray(jout.ops))
        assert np.array_equal(tout.valid.numpy(), valid)
        assert int(tst) == int(np.asarray(jst).view(np.int64))
        flipped += int((tout.ops.numpy() != ops).sum())
    assert flipped > 0


def test_troublemaker_corruption_is_caught():
    """``tests/test_ctl.py``'s scenario: flipped inserts reach a join side
    as deletes of never-inserted rows, which it counts."""
    from risingwave_tpu_torch.expr.node import InputRef
    from risingwave_tpu_torch.stream.fragment import Fragment
    from risingwave_tpu_torch.stream.hash_join import HashJoinExecutor

    schema = Schema.of(("k", DataType.INT64), ("v", DataType.INT64))
    tm = TroublemakerExecutor(schema, seed=7, ratio=4)
    frag = Fragment([tm])
    st = frag.init_states("cpu")
    arrays = [np.arange(64, dtype=np.int64), np.arange(64, dtype=np.int64)]
    st, out = frag.step(st, Chunk.from_numpy(schema, arrays))
    ops = [r[0] for r in out.to_rows()]
    assert ops.count(1) > 0
    join = HashJoinExecutor(schema, schema, [InputRef(0)], [InputRef(0)],
                            table_size=256, bucket_cap=4, out_capacity=256)
    jst = join.init_state("cpu")
    jst, _ = join.apply_begin(jst, out, "left")
    assert int(jst.left.inconsistency) == ops.count(1) > 0
