"""Two-phase aggregation: which calls decompose, and their global form.

Port of ``TWO_PHASE_KINDS`` and ``translated_global_calls`` from
``risingwave_tpu/stream/partial_agg.py`` (:39-52).  The pane rewrite of
HOP aggregations (``sql/planner.py``) uses them to combine per-pane
partials into per-window results.  ``PartialAggExecutor`` belongs to
the sharded path and is not ported yet.
"""

from __future__ import annotations

from typing import Sequence

from risingwave_tpu_torch.expr.agg import AggCall
from risingwave_tpu_torch.expr.node import InputRef

#: aggs decomposable into ONE signed/monoid partial column
TWO_PHASE_KINDS = {"count", "count_star", "sum", "sum0", "min", "max"}


def translated_global_calls(aggs: Sequence[AggCall], n_keys: int):
    """Global-phase calls reading the partial columns (same output
    arity and order as the original calls)."""
    combine = {"count": "sum0", "count_star": "sum0", "sum": "sum",
               "sum0": "sum0", "min": "min", "max": "max"}
    return [AggCall(combine[a.kind], InputRef(n_keys + i), a.alias or a.kind)
            for i, a in enumerate(aggs)]
