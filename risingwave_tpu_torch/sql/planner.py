"""Planner: bound SELECT -> streaming executor pipeline.

Port of the ``UnaryPlan`` part of ``risingwave_tpu/sql/planner.py``:
``_resolve_input`` for a source (with its watermark filter) and
TUMBLE/HOP windows, ``_plan_unary``, ``_plan_agg`` and
``_try_pane_agg`` (the pane rewrite of HOP aggregations, Nexmark q5)
and ``_append_terminal`` (materialize by pk, or the append-only ring);
an aggregation without watermark cleaning gets the reference's spill
ring (:1370-1381); and of ``DagPlan`` (:88) with the subset of
``_plan_join`` (:1641) that plans one equi-join of two inputs, each a
(possibly windowed and watermarked) source or a derived table
(``resolve_subquery``, :1741: an aggregation or a projection): every
join type of ``KIND_MAP`` (:1852), ``x [NOT] IN (SELECT ...)`` rewritten
to a semi/anti join (``_rewrite_in_subqueries``, :220), the one-sided ON
push-down of a left/right outer join (:1971-2034), pool storage for an
append-only input and dense buckets for a retractable one (or with
``join_force_dense``, :2050), the semi/anti output scope (:2059), the
windows' cleaning specs, and the output's stream key and
append-only-ness (:2096-2112) for the terminal: a ring after an inner
join of append-only inputs (Nexmark q8), else an MV keyed by the stream
key or the whole row (Nexmark q101, q103, q104).  The plan shapes built
here are the reference's, executor for executor.

Window functions (``_build_over_window``, ``_plan_over_window``,
:1007-1131) plan one ``OverWindowExecutor`` per SELECT (one shared OVER
clause), with the post-projection and an MV keyed by the whole row; over
a row_number subquery (the reference's "q6 shape", :1161-1166) the
over-window follows the group top-N.

The planner knows the device its plans run on.  For CUDA it refuses, as
``PlanError`` when the MV is created, what the card's kernels cannot run
although the plain versions can: each executor's ``cuda_refusal`` names
it (K17's non-integer order keys, K5's string and float group keys and
value dtypes, K6's min/max over float64, the kernels' column limits).

The group top-N rewrite (:725-832) plans ``SELECT .. FROM (SELECT *,
ROW_NUMBER() OVER (PARTITION BY p ORDER BY o) rn FROM t) WHERE rn <= k``
(Nexmark q19, q18) as the reference does: the inner query without its
window item, a ``GroupTopNExecutor`` after its projection, the outer
WHERE residue and projection, and an MV keyed by the whole row
(``_append_terminal``, :1135-1210, with the plain ``ORDER BY .. LIMIT``
TopN of the same executor).

An MV as a FROM item is an ``MvTap`` (:78, ``_resolve_input``'s MV
branch, :856-865): it carries the upstream's append-only-ness and stream
key, so a retractable upstream plans as retractable, and a unary plan
over it becomes a one-node ``DagPlan`` (a cascade, :204-212) that the
engine attaches to the upstream's job.  ``plan(..., sink=...)`` ends the
plan in a ``SinkExecutor`` instead of an MV (:1203-1216): the
``_hidden_`` columns are projected away first, and the ring takes
``mv_ring_size`` rows.

An aggregation over a join plans as q102's does (the join node, then a
fragment with the aggregation).  Not ported yet
(``PlanError``/``NotImplementedError``): non-equality ON conditions
other than an outer join's one-sided push-down, WHERE over a join,
nested (multi-way) and comma joins, EXISTS and scalar subqueries and a
derived table outside a join.
EMIT ON WINDOW CLOSE plans as the reference plans it (an aggregation
grouped by a watermarked window key, no pane rewrite, final rows into the
append-only ring) and refuses, with the reference's words, joins and
subqueries, window functions, a query without aggregation, ORDER BY ..
LIMIT and a group key that is not the window.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from risingwave_tpu_torch.common.types import Schema
from risingwave_tpu_torch.expr.node import Expr, FuncCall as EFuncCall, InputRef
from risingwave_tpu_torch.expr.scalar import RegexpGroup, ToChar
from risingwave_tpu_torch.meta.catalog import Catalog
from risingwave_tpu_torch.sql import ast
from risingwave_tpu_torch.sql.binder import (
    AGG_NAMES,
    AggRef,
    BindError,
    Binder,
    Scope,
)
from risingwave_tpu_torch.stream.executor import (
    Executor,
    FilterExecutor,
    HopWindowExecutor,
    ProjectExecutor,
)
from risingwave_tpu_torch.stream.fragment import Fragment
from risingwave_tpu_torch.stream.hash_agg import HashAggExecutor
from risingwave_tpu_torch.stream.hash_join import HashJoinExecutor
from risingwave_tpu_torch.stream.materialize import (
    AppendOnlyMaterialize,
    MaterializeExecutor,
)
from risingwave_tpu_torch.stream.over_window import (
    OverWindowExecutor,
    WindowFuncCall,
)
from risingwave_tpu_torch.stream.partial_agg import (
    TWO_PHASE_KINDS,
    translated_global_calls,
)
from risingwave_tpu_torch.stream.top_n import GroupTopNExecutor
from risingwave_tpu_torch.stream.watermark import WatermarkFilterExecutor


class PlanError(ValueError):
    pass


def _refuse_nullable_pool(schema: Schema, what: str) -> None:
    """A top-N or over-window pool stores every input column, and its
    row scatter takes no nullable column: refused at CREATE (the
    reference's pool scatter fails on the first tick too)."""
    nullable = [f.name for f in schema if f.nullable]
    if nullable:
        raise PlanError(f"{what} over the nullable column(s) "
                        f"{', '.join(nullable)}: a pool holds no NULLs, "
                        "not ported")


@dataclass
class PlannedInput:
    """One stream input after FROM resolution."""

    reader: Any
    executors: list[Executor]
    scope: Scope
    schema: Schema
    watermark_col: int | None
    window_size: int | None
    append_only: bool
    window_slide: int | None = None
    #: output positions that key a retractable input's rows, or None
    stream_key: "list[int] | None" = None


@dataclass
class UnaryPlan:
    reader: Any
    fragment: Fragment
    mv_index: int                # executor index of the MV in the fragment
    append_only: bool = True


@dataclass
class DagPlan:
    """A dataflow graph plan: ``nodes`` are the runtime's FragNode /
    JoinNode with plan-local refs: ("source", name) keys into
    ``sources``, ("node", i) indexes ``nodes``."""

    sources: dict[str, Any]
    nodes: list
    mv_node: int                 # node holding the terminal executor
    mv_index: int                # executor index within that node


@dataclass
class MvTap:
    """A FROM item that is an existing MV: the plan consumes that MV's
    output changelog (the reference's :78).  The engine resolves the tap
    to the running job's materialize node at CREATE time."""

    name: str


#: SQL join kinds -> the executor's join types
KIND_MAP = {"inner": "inner", "left": "left_outer", "right": "right_outer",
            "full": "full_outer", "cross": "inner", "semi": "left_semi",
            "anti": "left_anti"}


@dataclass
class GroupTopNSpec:
    """A row_number-in-subquery TopN rewrite in flight: the pieces the
    inner plan's construction carries (the reference's, :104)."""

    partition: tuple        # ast exprs, inner FROM scope
    order: tuple            # ast OrderItems, inner FROM scope
    limit: int
    offset: int
    outer_items: tuple      # outer SELECT items (inner-output scope)
    outer_where: tuple      # residual outer conjuncts
    alias: "str | None"     # subquery alias
    rank_alias: "str | None" = None  # emit the row_number as this


@dataclass
class PlannerConfig:
    """The reference's planner knobs, same names and defaults
    (``minput_bucket_cap``: the values each group keeps for a min/max
    over a retractable input, K6m's bucket width)."""

    agg_table_size: int = 1 << 16
    agg_emit_capacity: int = 4096
    join_table_size: int = 1 << 14
    join_bucket_cap: int = 64
    join_out_capacity: int = 1 << 15
    join_left_table_size: int | None = None
    join_right_table_size: int | None = None
    join_left_bucket_cap: int | None = None
    join_right_bucket_cap: int | None = None
    join_pool_size: int = 1 << 16
    join_force_dense: bool = False
    topn_pool_size: int = 4096
    topn_emit_capacity: int = 1024
    mv_table_size: int = 1 << 16
    mv_ring_size: int = 1 << 20
    chunk_capacity: int = 4096
    minput_bucket_cap: int = 64
    distinct_table_size: "int | None" = None
    agg_spill_ring: "int | None" = None
    agg_spill_table_size: "int | None" = None


class Planner:
    def __init__(self, catalog: Catalog, config: PlannerConfig | None = None,
                 device="cpu"):
        self.catalog = catalog
        self.config = config or PlannerConfig()
        #: the device the plans run on: CUDA refuses what its kernels lack
        self.device = torch.device(device)
        #: the session's streaming_parallelism at plan time (the engine
        #: sets it): above 1 the plans keep shapes the sharded job takes
        #: (the pane rewrite's two aggregations it cannot)
        self.parallel_hint = 1

    def plan(self, select: ast.Select, sink=None,
             eowc: bool = False) -> "UnaryPlan | DagPlan":
        """``sink`` replaces the MV terminal with a ``SinkExecutor``;
        ``eowc`` is EMIT ON WINDOW CLOSE."""
        plan = self._plan(select, sink, eowc)
        if self.device.type == "cuda":
            for ex in self._executors(plan):
                why = ex.cuda_refusal() if hasattr(ex, "cuda_refusal") \
                    else None
                if why is not None:
                    raise PlanError(f"{why} (on CUDA; the CPU runs it)")
        return plan

    @staticmethod
    def _executors(plan) -> list:
        """Every executor of a plan, its joins included."""
        if isinstance(plan, UnaryPlan):
            return list(plan.fragment.executors)
        return [ex for node in plan.nodes
                for ex in (node.fragment.executors
                           if hasattr(node, "fragment") else [node.join])]

    def _plan(self, select: ast.Select, sink,
              eowc: bool) -> "UnaryPlan | DagPlan":
        """``eowc``: EMIT ON WINDOW CLOSE (final append-only rows when
        windows close; the reference's :174-203).  A unary plan over an
        MV is a cascade: one fragment node tapping the upstream MV
        (:204-212)."""
        plan = self._plan_select(select, sink, eowc)
        if isinstance(plan, UnaryPlan) and isinstance(plan.reader, MvTap):
            from risingwave_tpu_torch.stream.dag import FragNode

            return DagPlan(
                sources={plan.reader.name: plan.reader},
                nodes=[FragNode(plan.fragment,
                                ("source", plan.reader.name))],
                mv_node=0, mv_index=plan.mv_index)
        return plan

    def _plan_select(self, select: ast.Select, sink,
                     eowc: bool) -> "UnaryPlan | DagPlan":
        def has_subquery(f) -> bool:
            if isinstance(f, ast.SubqueryRef):
                return True
            if isinstance(f, ast.Join):
                return has_subquery(f.left) or has_subquery(f.right)
            return False

        rewritten = self._match_group_topn(select)
        if rewritten is not None:
            inner, spec = rewritten
            if isinstance(inner.from_, (ast.SubqueryRef, ast.Join)):
                if eowc:
                    raise PlanError("EMIT ON WINDOW CLOSE on "
                                    "joins/subqueries: next round")
                raise PlanError("a row_number subquery over a join or a "
                                "subquery is not ported yet")
            return self._plan_unary(inner, sink, group_topn=spec,
                                    eowc=eowc)
        select = self._rewrite_in_subqueries(select)
        if eowc and (isinstance(select.from_, ast.Join)
                     or has_subquery(select.from_)):
            raise PlanError(
                "EMIT ON WINDOW CLOSE on joins/subqueries: next round")
        if isinstance(select.from_, ast.SubqueryRef):
            raise PlanError("a derived table outside a join is not ported "
                            "yet")
        if isinstance(select.from_, ast.Join):
            return self._plan_join(select, sink)
        return self._plan_unary(select, sink, eowc=eowc)

    # -- IN (SELECT ...) rewrite ----------------------------------------
    def _rewrite_in_subqueries(self, select: ast.Select) -> ast.Select:
        """``x [NOT] IN (SELECT c FROM ...)`` conjuncts of WHERE become
        semi/anti joins against the subquery (the reference's, :220).
        As there, the anti join treats a NULL key as non-matching (SQL's
        ``NOT IN`` over NULLs is never true); Nexmark's columns are NOT
        NULL."""
        if select.where is None:
            return select
        conjs = self._conjuncts(select.where)
        ins = [c for c in conjs if isinstance(c, ast.InSubquery)]
        if not ins:
            return select
        rest = [c for c in conjs if not isinstance(c, ast.InSubquery)]
        from_ = select.from_
        for k, c in enumerate(ins):
            sub = c.select
            if len(sub.items) != 1 or isinstance(sub.items[0].expr,
                                                 ast.Star):
                raise PlanError("IN subquery must select exactly one column")
            alias = f"_in_sq{k}"
            col_name = sub.items[0].alias or self._default_name(
                sub.items[0].expr, 0)
            from_ = ast.Join(
                left=from_, right=ast.SubqueryRef(sub, alias),
                on=ast.BinaryOp("equal", c.expr,
                                ast.ColumnRef(col_name, alias)),
                kind="anti" if c.negated else "semi")
        where = None
        for r in rest:
            where = r if where is None else ast.BinaryOp("and", where, r)
        return dataclasses.replace(select, from_=from_, where=where)

    # -- GroupTopN (row_number-in-subquery) rewrite ---------------------
    def _match_group_topn(self, select: ast.Select):
        """Detect SELECT .. FROM (SELECT *, ROW_NUMBER() OVER (..) rn
        FROM ..) WHERE rn <= k and return (inner-sans-window, spec)."""
        f = select.from_
        if not isinstance(f, ast.SubqueryRef):
            return None
        inner = f.select
        if (inner.order_by or inner.limit is not None or inner.offset
                or inner.group_by or inner.having is not None):
            return None
        wins = [(i, it) for i, it in enumerate(inner.items)
                if isinstance(it.expr, ast.WindowCall)]
        if len(wins) != 1:
            return None
        wi, witem = wins[0]
        w = witem.expr
        if w.name != "row_number" or w.frame is not None or not w.order_by:
            return None
        rank_name = witem.alias or "row_number"
        if select.where is None:
            return None
        limit = offset = None
        rest: list = []
        for c in self._conjuncts(select.where):
            lo = self._rank_bound(c, rank_name, f.alias)
            if lo is not None and limit is None:
                limit, offset = lo
            else:
                rest.append(c)
        if limit is None:
            return None
        if select.order_by or select.limit is not None or select.offset:
            return None  # outer ORDER/LIMIT over group topn

        # does the outer query use the rank column (by name or via *)?
        # Then the TopN emits its row_number.
        def refs_rank(e) -> bool:
            if isinstance(e, ast.ColumnRef):
                return e.name == rank_name
            if isinstance(e, ast.Case):
                return any(refs_rank(c) or refs_rank(r)
                           for c, r in e.conditions) or (
                    e.else_result is not None
                    and refs_rank(e.else_result))
            return any(
                refs_rank(x) for x in getattr(e, "args", ())
                if not isinstance(x, ast.Star)
            ) or any(
                refs_rank(getattr(e, a)) for a in ("left", "right",
                                                   "operand")
                if getattr(e, a, None) is not None)

        has_star = any(isinstance(it.expr, ast.Star) for it in select.items)
        with_rank = has_star or any(
            not isinstance(it.expr, ast.Star) and refs_rank(it.expr)
            for it in select.items
        ) or any(refs_rank(c) for c in rest)
        if has_star and wi != len(inner.items) - 1:
            # the rank column is appended LAST by the rewrite; a * over
            # a mid-list window item would reorder columns
            return None
        inner2 = dataclasses.replace(
            inner, items=tuple(it for i, it in enumerate(inner.items)
                               if i != wi))
        spec = GroupTopNSpec(
            partition=tuple(w.partition_by), order=tuple(w.order_by),
            limit=limit, offset=offset,
            outer_items=tuple(select.items), outer_where=tuple(rest),
            alias=f.alias,
            rank_alias=rank_name if with_rank else None)
        return inner2, spec

    @staticmethod
    def _rank_bound(c, rank_name: str, alias: "str | None" = None):
        """rn <= k / rn < k / rn = k / k >= rn -> (limit, offset)."""
        def is_rank(e) -> bool:
            return (isinstance(e, ast.ColumnRef) and e.name == rank_name
                    and e.table in (None, alias))

        if not isinstance(c, ast.BinaryOp):
            return None
        op, left, right = c.op, c.left, c.right
        if is_rank(right):
            flip = {"greater_than_or_equal": "less_than_or_equal",
                    "greater_than": "less_than",
                    "equal": "equal"}.get(op)
            if flip is None:
                return None
            op, left, right = flip, right, left
        if not (is_rank(left)
                and isinstance(right, ast.Literal)
                and right.type_name == "int"):
            return None
        k = right.value
        if op == "less_than_or_equal" and k >= 1:
            return (k, 0)
        if op == "less_than" and k >= 2:
            return (k - 1, 0)
        if op == "equal" and k >= 1:
            return (1, k - 1)
        return None

    def _resolve_group_topn(self, spec: GroupTopNSpec, scope: Scope,
                            proj: list):
        """Bind the partition/order keys in the INNER scope and locate
        them in the projection (appending hidden columns as needed);
        returns (group_positions, [(position, desc)], spec)."""
        b = Binder(scope)

        def locate(bexpr) -> int:
            for pi, (_, pe) in enumerate(proj):
                if self._expr_eq(pe, bexpr):
                    return pi
            proj.append((f"_hidden_gtn{len(proj)}", bexpr))
            return len(proj) - 1

        group_pos = [locate(b.bind(e)) for e in spec.partition]
        order_pos = [(locate(b.bind(oi.expr)), oi.descending)
                     for oi in spec.order]
        return (group_pos, order_pos, spec)

    # -- joins ------------------------------------------------------------
    def _plan_join(self, select: ast.Select, sink=None) -> DagPlan:
        """One equi-join of two inputs as a DagPlan: each input is a
        source plus its prep fragment (watermark filter, window) or a
        derived table's fragment, then the JoinNode, then the project
        and its terminal (a ring or an MV)."""
        from risingwave_tpu_torch.stream.dag import FragNode, JoinNode

        cfg = self.config
        sources: dict[str, Any] = {}
        nodes: list = []
        jn = select.from_
        temporal = jn.kind in ("temporal", "temporal_left")
        join_type = KIND_MAP.get(jn.kind)
        if join_type is None and not temporal:
            raise PlanError(f"unsupported join kind {jn.kind!r}")
        if jn.on is None:
            raise PlanError("joins without ON (comma joins) are not ported "
                            "yet")
        if select.where is not None:
            raise PlanError("WHERE over a join is not ported yet")

        def resolve(from_):
            if isinstance(from_, ast.Join):
                raise PlanError("nested joins are not ported yet")
            if isinstance(from_, ast.SubqueryRef):
                return resolve_subquery(from_)
            pin = self._resolve_input(from_)
            if isinstance(from_, ast.TableRef):
                base = from_.alias or from_.name
            else:
                base = from_.alias or from_.table.name
            name, i = base, 1
            while name in sources:
                name = f"{base}_{i}"
                i += 1
            sources[name] = pin.reader
            ref = ("source", name)
            if pin.executors:
                nodes.append(FragNode(Fragment(pin.executors), ref))
                ref = ("node", len(nodes) - 1)
            return ref, pin

        def resolve_subquery(sq: ast.SubqueryRef):
            """A derived table becomes its own fragment node: its WHERE
            filters, then its aggregation or projection."""
            inner = self._rewrite_in_subqueries(sq.select)
            if inner.order_by or inner.limit is not None or inner.offset:
                raise PlanError("ORDER BY/LIMIT in a FROM subquery is not "
                                "ported yet")
            if any(isinstance(i.expr, ast.WindowCall) for i in inner.items):
                raise PlanError("window functions in a FROM subquery are "
                                "not ported yet")
            if isinstance(inner.from_, (ast.Join, ast.SubqueryRef)):
                raise PlanError("nested joins and subqueries as join "
                                "inputs are not ported yet")
            ref, iinfo = resolve(inner.from_)
            scope = iinfo.scope
            execs: list[Executor] = []
            if inner.where is not None:
                execs += [FilterExecutor(scope.schema,
                                         Binder(scope).bind(c))
                          for c in self._conjuncts(inner.where)]
            if bool(inner.group_by) or self._has_agg(inner):
                execs2, out_schema, pk_positions = self._plan_agg(
                    inner, scope, iinfo)
                execs += execs2
                append_only = False
            else:
                b = Binder(scope)
                proj = [(nm, b.bind(e))
                        for nm, e in self._expand_items(inner.items, scope)]
                pk_positions = []
                if not iinfo.append_only:
                    if iinfo.stream_key is None:
                        raise PlanError("retractable subquery input without "
                                        "a stream key")
                    pk_positions = self._stream_key_projection(
                        proj, scope.schema, iinfo.stream_key)
                execs.append(ProjectExecutor(scope.schema, proj))
                out_schema = execs[-1].out_schema
                append_only = iinfo.append_only
            if execs:
                nodes.append(FragNode(Fragment(execs), ref))
                ref = ("node", len(nodes) - 1)
            return ref, PlannedInput(
                None, [], Scope.of(out_schema, sq.alias), out_schema, None,
                None, append_only, stream_key=pk_positions or None)

        if temporal:
            root_ref, both, skey, append_only = self._plan_temporal(
                jn, resolve, nodes)
            return self._plan_join_tail(select, sources, nodes, root_ref,
                                        both, skey, append_only,
                                        resolve_subquery, sink)
        lref, left = resolve(jn.left)
        rref, right = resolve(jn.right)
        n_left = len(left.schema)
        left_keys: list[Expr] = []
        right_keys: list[Expr] = []
        residual: list = []
        for conj in self._conjuncts(jn.on):
            keypair = self._equi_pair(conj, left.scope, right.scope, n_left)
            if keypair is None:
                residual.append(conj)
                continue
            left_keys.append(keypair[0])
            right_keys.append(keypair[1])
        if not left_keys:
            raise PlanError("JOIN requires at least one equality condition")
        if residual and join_type in ("left_outer", "right_outer"):
            # an ON predicate over the null-padded side alone filters that
            # input below the join (rows failing it do not match, and the
            # preserved side still pads)
            padded = "right" if join_type == "left_outer" else "left"
            pin = right if padded == "right" else left
            other = left if padded == "right" else right
            kept, pushed = [], []
            for conj in residual:
                try:
                    if not self._refs_only(conj, pin.scope, other.scope):
                        raise BindError("not one-sided")
                    pushed.append(FilterExecutor(
                        pin.scope.schema, Binder(pin.scope).bind(conj)))
                except BindError:
                    kept.append(conj)
            if pushed:
                src = rref if padded == "right" else lref
                nodes.append(FragNode(Fragment(pushed), src))
                if padded == "right":
                    rref = ("node", len(nodes) - 1)
                else:
                    lref = ("node", len(nodes) - 1)
            residual = kept
        if residual:
            raise PlanError("non-equality ON conditions are not ported yet "
                            "(an outer join's condition on its padded side "
                            "alone is)")
        dense = cfg.join_force_dense
        join = HashJoinExecutor(
            left.schema, right.schema, left_keys, right_keys,
            table_size=cfg.join_table_size,
            bucket_cap=cfg.join_bucket_cap,
            out_capacity=cfg.join_out_capacity,
            left_table_size=cfg.join_left_table_size,
            right_table_size=cfg.join_right_table_size,
            left_bucket_cap=cfg.join_left_bucket_cap,
            right_bucket_cap=cfg.join_right_bucket_cap,
            join_type=join_type,
            # append-only sides take the degree-adaptive pool; retractable
            # sides need deletes by value in dense buckets
            left_storage="pool" if left.append_only and not dense
            else "dense",
            right_storage="pool" if right.append_only and not dense
            else "dense",
            left_pool_size=cfg.join_pool_size,
            right_pool_size=cfg.join_pool_size,
        )
        if join.is_semi or join.is_anti:
            pres = left if join.preserve_left else right
            both = Scope(join.out_schema, tuple(pres.scope.qualifiers))
        else:
            both = Scope(join.out_schema, tuple(left.scope.qualifiers)
                         + tuple(right.scope.qualifiers))
        # window-keyed joins over watermarked inputs clean closed windows
        # at barriers
        for side_name, pin, keys in (("left", left, left_keys),
                                     ("right", right, right_keys)):
            if pin.window_size is None or pin.watermark_col is None:
                continue
            window_idxs = [i for i, f in enumerate(pin.schema)
                           if f.name in ("window_start", "window_end")]
            for ki, ke in enumerate(keys):
                if isinstance(ke, InputRef) and ke.index in window_idxs:
                    setattr(join, f"{side_name}_clean",
                            (ki, pin.window_size, pin.watermark_col))
                    break
        nodes.append(JoinNode(join, lref, rref))
        root_ref = ("node", len(nodes) - 1)
        # only an inner join of append-only inputs stays append-only
        # (outer pads retract); its stream key is both inputs' keys, a
        # semi/anti join's the preserved side's
        if join.emit_pairs:
            skey = None
            if left.stream_key is not None and right.stream_key is not None:
                skey = list(left.stream_key) + [n_left + k
                                                for k in right.stream_key]
        else:
            skey = (left if join.preserve_left else right).stream_key
        append_only = left.append_only and right.append_only \
            and join_type == "inner"
        return self._plan_join_tail(select, sources, nodes, root_ref, both,
                                    skey, append_only, resolve_subquery,
                                    sink)

    def _plan_temporal(self, jn: ast.Join, resolve, nodes: list):
        """``stream JOIN t FOR SYSTEM_TIME AS OF PROCTIME() ON ...`` (the
        reference's ``resolve_temporal``, planner.py:1864): equality keys
        covering the build side's PRIMARY KEY exactly, taken in pk order
        (probe keys may be expressions), the other ON conjuncts a filter
        after the join.  Build-side changes never retract outputs, so
        the output is append-only when the probe side is.  Returns
        (root ref, output scope, stream key, append-only)."""
        from risingwave_tpu_torch.stream.dag import FragNode, TemporalJoinNode
        from risingwave_tpu_torch.stream.temporal_join import (
            TemporalJoinExecutor,
        )

        join_type = "inner" if jn.kind == "temporal" else "left_outer"
        lref, left = resolve(jn.left)
        rref, right = resolve(jn.right)
        n_left = len(left.schema)
        if not right.stream_key:
            raise PlanError("temporal join build side needs a PRIMARY KEY")
        lkeys: list = []
        ridx: list[int] = []
        residual: list = []
        for conj in self._conjuncts(jn.on):
            kp = self._equi_pair(conj, left.scope, right.scope, n_left)
            if kp is None:
                residual.append(conj)
                continue
            lk, rk = kp
            if not isinstance(rk, InputRef):
                raise PlanError(
                    "temporal join keys must be build-side columns")
            lkeys.append(lk)
            ridx.append(rk.index)
        if set(ridx) != set(right.stream_key):
            raise PlanError(
                "temporal join requires equality keys covering the build "
                f"side's PRIMARY KEY exactly (got cols {sorted(ridx)}, pk "
                f"{sorted(right.stream_key)})")
        order = [ridx.index(pk) for pk in right.stream_key]
        join = TemporalJoinExecutor(
            left.schema, right.schema, [lkeys[i] for i in order],
            list(right.stream_key), table_size=self.config.join_table_size,
            join_type=join_type)
        nodes.append(TemporalJoinNode(join, lref, rref))
        ref = ("node", len(nodes) - 1)
        both = Scope(join.out_schema, tuple(left.scope.qualifiers)
                     + tuple(right.scope.qualifiers))
        if residual:
            b = Binder(both)
            nodes.append(FragNode(Fragment([
                FilterExecutor(both.schema, b.bind(c)) for c in residual
            ]), ref))
            ref = ("node", len(nodes) - 1)
        return ref, both, left.stream_key, left.append_only

    def _plan_join_tail(self, select: ast.Select, sources: dict, nodes: list,
                        root_ref, both: Scope, skey, append_only: bool,
                        resolve_subquery, sink=None) -> DagPlan:
        """The join's consumer: an aggregation over it, or the projection
        and its terminal (a ring, an MV or the sink)."""
        from risingwave_tpu_torch.stream.dag import FragNode

        if bool(select.group_by) or self._has_agg(select):
            root = PlannedInput(None, [], both, both.schema, None, None,
                                append_only, stream_key=skey)
            return self._plan_join_agg(select, sources, nodes, root_ref,
                                       root, resolve_subquery, sink)
        b = Binder(both)
        proj = [(name, b.bind(e))
                for name, e in self._expand_items(select.items, both)]
        pk_positions: list[int] = []
        if sink is None and not append_only and skey is not None:
            pk_positions = self._stream_key_projection(proj, both.schema,
                                                       skey)
        post_execs: list[Executor] = [ProjectExecutor(both.schema, proj)]
        self._append_terminal(post_execs, post_execs[-1].out_schema, select,
                              input_append_only=append_only, has_agg=False,
                              pk_positions=pk_positions, sink=sink)
        nodes.append(FragNode(Fragment(post_execs), root_ref))
        return DagPlan(sources, nodes, len(nodes) - 1, len(post_execs) - 1)

    def _plan_join_agg(self, select: ast.Select, sources: dict, nodes: list,
                       root_ref, root: PlannedInput,
                       resolve_subquery, sink=None) -> DagPlan:
        """An aggregation over the join (the reference's :2163-2230): the
        join's retractions flow into the aggregation.  HAVING conjuncts
        that compare against an uncorrelated scalar subquery peel off
        into dynamic filters (Nexmark q102): the aggregation emits each
        compared value as a hidden column, and each filter's right input
        is the subquery's own plan (a global aggregation)."""
        from risingwave_tpu_torch.stream.dag import FilterNode, FragNode
        from risingwave_tpu_torch.stream.dynamic_filter import (
            DynamicFilterExecutor,
        )

        having_subs: list = []
        if select.having is not None:
            plain_hv = []
            for c in self._conjuncts(select.having):
                m = self._match_scalar_sub_cmp(c)
                if m is None:
                    plain_hv.append(c)
                elif not self._is_uncorrelated(m[2]):
                    raise PlanError("correlated scalar subqueries are not "
                                    "ported yet")
                else:
                    having_subs.append(m)
            if having_subs:
                new_hv = None
                for r in plain_hv:
                    new_hv = r if new_hv is None \
                        else ast.BinaryOp("and", new_hv, r)
                select = dataclasses.replace(select, having=new_hv)
        cfg = self.config
        execs, out_schema, pk_pos, extra_pos = self._plan_agg(
            select, root.scope, root,
            extra_out=[lhs for lhs, _, _ in having_subs])
        ref = root_ref
        if having_subs:
            nodes.append(FragNode(Fragment(execs), ref))
            ref = ("node", len(nodes) - 1)
            execs = []
        for (lhs, cmp, sub), pos in zip(having_subs, extra_pos):
            if len(sub.items) != 1 or isinstance(sub.items[0].expr,
                                                 ast.Star):
                raise PlanError("scalar subquery must select exactly one "
                                "column")
            sref, _ = resolve_subquery(ast.SubqueryRef(
                sub, f"_sc_sq{len(nodes)}"))
            nodes.append(FilterNode(DynamicFilterExecutor(
                out_schema, filter_col=pos, cmp=cmp,
                pool_size=max(cfg.topn_pool_size, 2 * cfg.chunk_capacity)),
                ref, sref))
            ref = ("node", len(nodes) - 1)
        # the terminal joins the aggregation's fragment, or follows the
        # last filter in a fragment of its own
        self._append_terminal(execs, out_schema, select,
                              input_append_only=False, has_agg=True,
                              pk_positions=pk_pos, sink=sink)
        nodes.append(FragNode(Fragment(execs), ref))
        return DagPlan(sources, nodes, len(nodes) - 1, len(execs) - 1)

    _SUB_CMPS = {"greater_than": "gt", "greater_than_or_equal": "ge",
                 "less_than": "lt", "less_than_or_equal": "le",
                 "equal": "eq"}
    _SUB_FLIP = {"gt": "lt", "ge": "le", "lt": "gt", "le": "ge",
                 "eq": "eq"}

    def _match_scalar_sub_cmp(self, c):
        """``lhs CMP (SELECT ...)`` -> (lhs ast, cmp, subquery select)."""
        if not (isinstance(c, ast.BinaryOp) and c.op in self._SUB_CMPS):
            return None
        cmp = self._SUB_CMPS[c.op]
        if isinstance(c.right, ast.ScalarSubquery) \
                and not isinstance(c.left, ast.ScalarSubquery):
            return (c.left, cmp, c.right.select)
        if isinstance(c.left, ast.ScalarSubquery) \
                and not isinstance(c.right, ast.ScalarSubquery):
            return (c.right, self._SUB_FLIP[cmp], c.left.select)
        return None

    def _from_name_sets(self, from_):
        """(names, (qualifier, name) pairs) visible from a FROM tree."""
        names: set = set()
        quals: set = set()
        if isinstance(from_, ast.Join):
            for side in (from_.left, from_.right):
                n, q = self._from_name_sets(side)
                names |= n
                quals |= q
            return names, quals
        if isinstance(from_, ast.SubqueryRef):
            for i, it in enumerate(from_.select.items):
                if isinstance(it.expr, ast.Star):
                    n, _ = self._from_name_sets(from_.select.from_)
                    names |= n
                    continue
                nm = it.alias or self._default_name(it.expr, i)
                names.add(nm)
                if from_.alias:
                    quals.add((from_.alias, nm))
            return names, quals
        if isinstance(from_, (ast.Tumble, ast.Hop)):
            n, _ = self._from_name_sets(from_.table)
            names |= n | {"window_start", "window_end"}
            return names, quals
        try:
            entry = self.catalog.get(from_.name)
        except Exception:
            return names, quals
        qual = from_.alias or from_.name
        for f in entry.schema:
            names.add(f.name)
            quals.add((qual, f.name))
        return names, quals

    def _is_uncorrelated(self, sub: ast.Select) -> bool:
        """Every column the subquery references resolves in its own FROM:
        it plans as an independent 1-row changelog."""
        names, quals = self._from_name_sets(sub.from_)

        def local(r) -> bool:
            if r.table is not None:
                return (r.table, r.name) in quals
            return r.name in names

        exprs = [it.expr for it in sub.items
                 if not isinstance(it.expr, ast.Star)]
        if sub.where is not None:
            exprs.append(sub.where)
        exprs.extend(sub.group_by)
        if sub.having is not None:
            exprs.append(sub.having)
        return all(local(r) for e in exprs for r in self._column_refs(e))

    @staticmethod
    def _refs_only(conj, scope: Scope, other: Scope) -> bool:
        """Whether ``conj`` has columns, all resolving in ``scope`` and
        no unqualified one also in ``other`` (ambiguous: kept, so that
        the full-scope bind raises)."""
        refs = Planner._column_refs(conj)
        for r in refs:
            scope.resolve(r.name, r.table)
            if r.table is None:
                try:
                    other.resolve(r.name, None)
                    return False
                except BindError:
                    pass
        return bool(refs)

    @staticmethod
    def _column_refs(e) -> list:
        """All ColumnRefs of an AST expression."""
        out: list = []
        stack = [e]
        while stack:
            x = stack.pop()
            if isinstance(x, ast.ColumnRef):
                out.append(x)
            elif isinstance(x, ast.Case):
                for c, r in x.conditions:
                    stack += [c, r]
                if x.else_result is not None:
                    stack.append(x.else_result)
            else:
                for a in ("left", "right", "operand", "expr"):
                    v = getattr(x, a, None)
                    if v is not None and not isinstance(v, str):
                        stack.append(v)
                stack.extend(a for a in getattr(x, "args", ())
                             if not isinstance(a, ast.Star))
        return out

    @staticmethod
    def _stream_key_projection(proj: list, schema: Schema,
                               stream_key) -> list[int]:
        """Keep the stream-key columns through a projection (hidden when
        unselected); returns their output positions (the MV's pk)."""
        pk_positions: list[int] = []
        for ki in stream_key:
            pos = next((pi for pi, (_, e) in enumerate(proj)
                        if isinstance(e, InputRef) and e.index == ki), None)
            if pos is None:
                proj.append((f"_hidden_{schema[ki].name}", InputRef(ki)))
                pos = len(proj) - 1
            pk_positions.append(pos)
        return pk_positions

    @staticmethod
    def _conjuncts(e) -> list:
        if isinstance(e, ast.BinaryOp) and e.op == "and":
            return Planner._conjuncts(e.left) + Planner._conjuncts(e.right)
        return [e]

    @staticmethod
    def _equi_pair(e, lscope: Scope, rscope: Scope, n_left: int):
        """(left key, right key) of an ``l = r`` conjunct whose operands
        bind on opposite sides, else None."""
        if not (isinstance(e, ast.BinaryOp) and e.op == "equal"):
            return None
        sides = []
        for operand in (e.left, e.right):
            try:
                sides.append(("l", Binder(lscope).bind(operand)))
                continue
            except BindError:
                pass
            try:
                sides.append(("r", Binder(rscope).bind(operand)))
            except BindError:
                return None
        if {t for t, _ in sides} != {"l", "r"}:
            return None
        return (next(x for t, x in sides if t == "l"),
                next(x for t, x in sides if t == "r"))

    # -- inputs ---------------------------------------------------------
    def _resolve_input(self, from_) -> PlannedInput:
        if isinstance(from_, ast.TableRef):
            entry = self.catalog.get(from_.name)
            if entry.kind == "mview":
                # MV-on-MV: consume the upstream MV's output changelog
                return PlannedInput(
                    MvTap(from_.name), [],
                    Scope.of(entry.schema, from_.alias or from_.name),
                    entry.schema, None, None, entry.append_only,
                    stream_key=entry.stream_key)
            if entry.kind != "source":
                raise PlanError(f"{from_.name} is not a streaming source or "
                                "materialized view")
            execs: list[Executor] = []
            wm_col = None
            if entry.watermark is not None:
                col, delay = entry.watermark
                execs.append(WatermarkFilterExecutor(entry.schema, col, delay))
                wm_col = col
            # a table's stream key is its PRIMARY KEY
            return PlannedInput(
                entry.reader_factory(), execs,
                Scope.of(entry.schema, from_.alias or from_.name),
                entry.schema, wm_col, None, entry.append_only,
                stream_key=list(entry.stream_key) if entry.stream_key
                else None)
        if isinstance(from_, (ast.Tumble, ast.Hop)):
            inner = self._resolve_input(from_.table)
            ts_idx = inner.scope.resolve(from_.time_col, None)
            size = from_.size.micros
            slide = size if isinstance(from_, ast.Tumble) \
                else from_.slide.micros
            hop = HopWindowExecutor(inner.schema, ts_idx, slide, size)
            qual = from_.alias or from_.table.name
            if from_.alias:
                quals = tuple(qual for _ in hop.out_schema)
            else:
                quals = tuple(inner.scope.qualifiers) + (qual, qual)
            return PlannedInput(
                inner.reader, inner.executors + [hop],
                Scope(hop.out_schema, quals), hop.out_schema,
                inner.watermark_col, size, inner.append_only,
                window_slide=slide)
        raise PlanError(f"unsupported FROM clause {from_!r}")

    # -- unary pipelines -------------------------------------------------
    def _plan_unary(self, select: ast.Select, sink=None,
                    group_topn: GroupTopNSpec | None = None,
                    eowc: bool = False) -> UnaryPlan:
        if select.from_ is None:
            raise PlanError("SELECT without FROM is not a streaming job")
        pin = self._resolve_input(select.from_)
        execs = list(pin.executors)
        scope = pin.scope
        if select.where is not None:
            execs.append(FilterExecutor(scope.schema,
                                        Binder(scope).bind(select.where)))
        if any(isinstance(i.expr, ast.WindowCall) for i in select.items):
            if sink is not None or eowc:
                raise PlanError(
                    "window functions with sinks/EOWC: next round")
            return self._plan_over_window(select, pin, execs, scope)
        has_agg = bool(select.group_by) or self._has_agg(select)
        if has_agg and group_topn is not None:
            raise PlanError("row_number subquery over an aggregation is "
                            "not ported yet")
        if eowc and not has_agg:
            raise PlanError(
                "EMIT ON WINDOW CLOSE needs GROUP BY window_start over a "
                "watermarked windowed source")
        pk_positions: list[int] = []
        gtn = None
        if has_agg:
            pane = None if eowc or self.parallel_hint > 1 \
                else self._try_pane_agg(select, scope, pin, execs)
            if pane is None:
                pane = self._plan_agg(select, scope, pin, eowc=eowc)
            execs2, out_schema, pk_positions = pane
            execs.extend(execs2)
        else:
            b = Binder(scope)
            proj = [(name, b.bind(e))
                    for name, e in self._expand_items(select.items, scope)]
            if not pin.append_only:
                # a retractable input (a table WITH (retract = 'true'))
                # stays keyed by its stream key so that deletes reach
                # the right MV row
                if pin.stream_key is None:
                    raise PlanError("retractable input without a stream key "
                                    "cannot be materialized")
                pk_positions = self._stream_key_projection(
                    proj, scope.schema, pin.stream_key)
            if group_topn is not None:
                gtn = self._resolve_group_topn(group_topn, scope, proj)
            execs.append(ProjectExecutor(scope.schema, proj))
            out_schema = execs[-1].out_schema
        self._append_terminal(execs, out_schema, select,
                              input_append_only=pin.append_only,
                              has_agg=has_agg, pk_positions=pk_positions,
                              sink=sink, group_topn=gtn, eowc=eowc)
        return UnaryPlan(pin.reader, Fragment(execs), len(execs) - 1,
                         append_only=pin.append_only)

    def _try_pane_agg(self, select: ast.Select, scope: Scope,
                      pin: PlannedInput, execs: list):
        """Sliding-window (HOP) aggregation through PANES (reference
        planner.py:1424): aggregate each event once into tumbling panes
        of the slide's width, expand only the pane DELTAS into their k
        covering windows, and combine them with the translated
        two-phase calls.  ``execs`` is edited in place (the hop becomes
        the pane tumble).

        Eligible: append-only, watermarked hop input, GROUP BY
        window_start + keys, two-phase calls without DISTINCT/FILTER,
        linear (unsharded) plans.  Returns None when ineligible (the plain hop plan follows)."""
        size, slide = pin.window_size, pin.window_slide
        if not pin.append_only or size is None or slide is None \
                or slide >= size or size % slide != 0 \
                or pin.watermark_col is None:
            return None
        hop_pos = next((i for i, ex in enumerate(execs)
                        if isinstance(ex, HopWindowExecutor)), None)
        if hop_pos is None:
            return None
        hop = execs[hop_pos]
        ws_idx = len(hop.in_schema)  # window_start position (appended)

        def touches_window(e: Expr) -> bool:
            if isinstance(e, InputRef):
                return e.index >= ws_idx
            if isinstance(e, AggRef):
                return e.call.arg is not None and touches_window(e.call.arg)
            if isinstance(e, EFuncCall):
                return any(touches_window(a) for a in e.args)
            return False

        # bind group keys + items exactly as _plan_agg would
        in_binder = Binder(scope)
        group_by: list = []
        ws_key_pos = None
        for gi, ga in enumerate(select.group_by):
            name = ga.name if isinstance(ga, ast.ColumnRef) else f"_key{gi}"
            ge = in_binder.bind(ga)
            if isinstance(ge, InputRef) and ge.index == ws_idx:
                ws_key_pos = gi
            elif touches_window(ge):
                return None  # window_end/ts-derived keys: no pane form
            group_by.append((name, ge))
        if ws_key_pos is None:
            return None
        item_binder = Binder(scope, allow_aggs=True)
        bound_items = []
        for idx, item in enumerate(select.items):
            if isinstance(item.expr, ast.Star):
                raise PlanError("SELECT * with GROUP BY is not valid")
            name = item.alias or self._default_name(item.expr, idx)
            bound_items.append((name, item_binder.bind(item.expr)))
        having_expr = None
        if select.having is not None:
            having_expr = item_binder.bind(select.having)
        agg_calls = item_binder.agg_calls
        if any(a.kind not in TWO_PHASE_KINDS or a.distinct
               or a.filter is not None for a in agg_calls):
            return None
        if any(a.arg is not None and touches_window(a.arg)
               for a in agg_calls):
            return None
        # min/max over strings cannot combine retractably: no pane form
        for a in agg_calls:
            if a.kind in ("min", "max") and a.arg is not None \
                    and a.arg.return_field(scope.schema).data_type.is_string:
                return None
        # the WHERE filter (already in execs) must not read window cols
        if any(isinstance(ex, FilterExecutor) and touches_window(ex.predicate)
               for ex in execs):
            return None

        cfg = self.config
        n_keys = len(group_by)
        # 1. panes: tumble by slide (same schema and positions as the hop)
        execs[hop_pos] = HopWindowExecutor(hop.in_schema, hop.ts_col, slide,
                                           slide)
        # 2. per-pane partial agg (append-only); a pane is cleaned when
        # its LAST covering window closes: wm >= pane_start + size
        pane_agg = HashAggExecutor(
            execs[hop_pos].out_schema, group_by, agg_calls,
            table_size=cfg.agg_table_size,
            emit_capacity=cfg.agg_emit_capacity,
            watermark_group_idx=ws_key_pos, watermark_lag=size,
            watermark_src_col=pin.watermark_col)
        # 3. expand the PANE DELTAS to their k covering windows
        expand = HopWindowExecutor(pane_agg.out_schema, ws_key_pos, slide,
                                   size)
        n_pane_out = len(pane_agg.out_schema)
        # 4. combine partials per (keys..., window_start); pane updates
        # retract, so the global phase runs retractable: min/max there
        # keep materialized input (K6m), up to k live pane partials per
        # window and their U-/U+ turnover
        final_group = [(nm, InputRef(n_pane_out) if gi == ws_key_pos
                        else InputRef(gi))
                       for gi, (nm, _) in enumerate(group_by)]
        final_agg = HashAggExecutor(
            expand.out_schema, final_group,
            translated_global_calls(agg_calls, n_keys),
            table_size=cfg.agg_table_size,
            emit_capacity=cfg.agg_emit_capacity,
            watermark_group_idx=ws_key_pos, watermark_lag=size,
            watermark_src_col=pin.watermark_col,
            retractable_input=True,
            minput_bucket_cap=max(cfg.minput_bucket_cap, 2 * (size // slide)))
        execs2: list[Executor] = [pane_agg, expand, final_agg]

        # post projection / having / pk: _plan_agg's tail over the final
        # agg's output [keys..., agg outs...]
        rewritten = [(name, self._rewrite_post_agg(e, group_by, n_keys))
                     for name, e in bound_items]
        selected_keys = {e.index for _, e in rewritten
                         if isinstance(e, InputRef) and e.index < n_keys}
        hidden = [(f"_hidden_{final_agg.out_schema[ki].name}", InputRef(ki))
                  for ki in range(n_keys) if ki not in selected_keys]
        proj_items = rewritten + hidden
        if having_expr is not None:
            execs2.append(FilterExecutor(
                final_agg.out_schema,
                self._rewrite_post_agg(having_expr, group_by, n_keys)))
        post = ProjectExecutor(final_agg.out_schema, proj_items)
        execs2.append(post)
        pk_pos = []
        for ki in range(n_keys):
            for pi, (_, e) in enumerate(proj_items):
                if isinstance(e, InputRef) and e.index == ki:
                    pk_pos.append(pi)
                    break
        return execs2, post.out_schema, pk_pos

    def _append_terminal(self, execs, out_schema, select, *,
                         input_append_only: bool, has_agg: bool,
                         pk_positions, sink=None, group_topn=None,
                         eowc: bool = False) -> None:
        """Plan tail: the optional (group) TopN, then the sink, or
        materialize by pk (retractable) or into a ring (EOWC output is
        final append-only rows)."""
        has_topn = bool(select.order_by and select.limit is not None)
        pool = max(self.config.topn_pool_size,
                   2 * self.config.chunk_capacity)
        if group_topn is not None:
            group_pos, order_pos, spec = group_topn
            for pos, _ in order_pos:
                if out_schema[pos].nullable:
                    raise PlanError("row_number ORDER BY on a nullable "
                                    "column is not ported yet")
            _refuse_nullable_pool(out_schema, "a row_number top-N")
            execs.append(GroupTopNExecutor(
                out_schema,
                group_by=[InputRef(i) for i in group_pos],
                order_by=[(InputRef(i), d) for i, d in order_pos],
                limit=spec.limit, offset=spec.offset, pool_size=pool,
                emit_capacity=self.config.topn_emit_capacity,
                append_only=input_append_only,
                rank_alias=spec.rank_alias))
            out_schema = execs[-1].out_schema
            scope2 = Scope.of(out_schema, spec.alias)
            for c in spec.outer_where:
                execs.append(FilterExecutor(out_schema,
                                            Binder(scope2).bind(c)))
            if any(isinstance(it.expr, ast.WindowCall)
                   for it in spec.outer_items):
                # q6 shape: fn() OVER (...) over the group top-N's output
                out_schema = self._build_over_window(spec.outer_items,
                                                     scope2, execs)
            else:
                proj2 = [(nm, Binder(scope2).bind(e))
                         for nm, e in self._expand_items(spec.outer_items,
                                                         scope2)]
                execs.append(ProjectExecutor(out_schema, proj2))
                out_schema = execs[-1].out_schema
            # group-topn output is retractable, keyed by the whole row
            input_append_only = False
            pk_positions = list(range(len(out_schema)))
        if has_topn:
            if eowc:
                raise PlanError("ORDER BY ... LIMIT with EMIT ON WINDOW "
                                "CLOSE: next round")
            ob = []
            b = Binder(Scope.of(out_schema))
            for oi in select.order_by:
                ke = self._bind_order_key(oi.expr, b, out_schema)
                if ke.return_field(out_schema).nullable:
                    raise PlanError("ORDER BY on a nullable column in TopN "
                                    "is not ported yet")
                ob.append((ke, oi.descending))
            _refuse_nullable_pool(out_schema, "a top-N")
            # append-only up to here: the TopN can evict non-band rows
            execs.append(GroupTopNExecutor(
                out_schema, group_by=[], order_by=ob, limit=select.limit,
                offset=select.offset or 0, pool_size=pool,
                emit_capacity=self.config.topn_emit_capacity,
                append_only=input_append_only and not has_agg))
        if sink is not None:
            from risingwave_tpu_torch.stream.sink import SinkExecutor

            # the MV-pk bookkeeping columns must not leak to the sink
            visible = [i for i, f in enumerate(out_schema)
                       if not f.name.startswith("_hidden_")]
            if len(visible) != len(out_schema):
                execs.append(ProjectExecutor(
                    out_schema,
                    [(out_schema[i].name, InputRef(i)) for i in visible]))
                out_schema = execs[-1].out_schema
            execs.append(SinkExecutor(out_schema, sink,
                                      ring_size=self.config.mv_ring_size))
            return
        if (has_agg or has_topn or not input_append_only) and not eowc:
            # pk: group keys for aggs; the whole row for TopN output
            pk = list(range(len(out_schema))) if has_topn \
                else pk_positions or list(range(len(out_schema)))
            execs.append(MaterializeExecutor(
                out_schema, pk_indices=pk,
                table_size=self.config.mv_table_size))
        else:
            execs.append(AppendOnlyMaterialize(
                out_schema, ring_size=self.config.mv_ring_size))

    # -- window functions ---------------------------------------------------
    def _build_over_window(self, items, scope: Scope, execs: list) -> Schema:
        """Append an OverWindowExecutor and its post-projection for SELECT
        items with fn() OVER (...) calls (one shared OVER clause); returns
        the projected schema."""
        witems = [(item, item.expr) for item in items
                  if isinstance(item.expr, ast.WindowCall)]
        spec = (witems[0][1].partition_by, witems[0][1].order_by,
                witems[0][1].frame)
        for _, w in witems[1:]:
            if (w.partition_by, w.order_by, w.frame) != spec:
                raise PlanError("all window calls must share one OVER clause")
        b = Binder(scope)
        partition = [b.bind(e) for e in spec[0]]
        order = [(b.bind(oi.expr), oi.descending) for oi in spec[1]]
        for e in partition + [oe for oe, _ in order]:
            if e.return_field(scope.schema).nullable:
                raise PlanError("OVER (...) on nullable partition or order "
                                "columns is not ported yet")
        _refuse_nullable_pool(scope.schema, "an over-window")
        calls = []
        supported = {"row_number", "rank", "dense_rank", "lag", "lead",
                     "sum", "count", "avg", "min", "max"}
        needs_arg = {"lag", "lead", "sum", "avg", "min", "max"}
        framable = {"sum", "count", "avg"}
        for idx, (item, w) in enumerate(witems):
            if w.name not in supported:
                raise PlanError(f"window function {w.name} not supported")
            if w.frame is not None:
                if w.name not in framable:
                    raise PlanError(f"ROWS frames on {w.name}() OVER are not "
                                    "supported")
                if w.frame[1] != 0 or w.frame[0] < 0:
                    raise PlanError(
                        "only ROWS BETWEEN n PRECEDING AND CURRENT ROW "
                        "frames are supported")
            if w.name in needs_arg and (
                    not w.args or isinstance(w.args[0], ast.Star)):
                raise PlanError(f"{w.name}() OVER needs an argument")
            if w.name in ("lag", "lead") and len(w.args) > 2:
                raise PlanError("lag/lead default values are not supported")
            arg = b.bind(w.args[0]) if w.args and not isinstance(
                w.args[0], ast.Star) else None
            offset = 1
            if w.name in ("lag", "lead") and len(w.args) > 1:
                off_ast = w.args[1]
                if not (isinstance(off_ast, ast.Literal)
                        and off_ast.type_name == "int"):
                    raise PlanError("lag/lead offset must be an integer")
                offset = off_ast.value
            calls.append(WindowFuncCall(w.name, arg, offset,
                                        item.alias or f"{w.name}{idx}",
                                        frame=w.frame))
        ow = OverWindowExecutor(
            scope.schema, partition, order, calls,
            pool_size=max(self.config.topn_pool_size,
                          2 * self.config.chunk_capacity),
            emit_capacity=self.config.topn_emit_capacity)
        execs.append(ow)
        # post-projection: inputs by name, window outputs by position
        out_schema = ow.out_schema
        n_in = len(scope.schema)
        proj = []
        wi = 0
        post_b = Binder(Scope(out_schema, tuple(scope.qualifiers)
                              + tuple(None for _ in calls)))
        for idx, item in enumerate(items):
            if isinstance(item.expr, ast.WindowCall):
                proj.append((item.alias or calls[wi].alias,
                             InputRef(n_in + wi)))
                wi += 1
            elif isinstance(item.expr, ast.Star):
                for ci, f in enumerate(scope.schema):
                    if not f.name.startswith("_hidden_"):
                        proj.append((f.name, InputRef(ci)))
            else:
                proj.append((item.alias or self._default_name(item.expr, idx),
                             post_b.bind(item.expr)))
        execs.append(ProjectExecutor(out_schema, proj))
        return execs[-1].out_schema

    def _plan_over_window(self, select: ast.Select, pin, execs,
                          scope) -> UnaryPlan:
        """SELECT items with fn() OVER (...): one OverWindowExecutor and
        an MV keyed by the whole row."""
        if (select.group_by or select.having is not None
                or select.order_by or select.limit is not None
                or select.offset):
            raise PlanError("window functions with GROUP BY/HAVING/ORDER "
                            "BY/LIMIT in one SELECT are not supported")
        out_schema = self._build_over_window(select.items, scope, execs)
        execs.append(MaterializeExecutor(
            out_schema, pk_indices=list(range(len(out_schema))),
            table_size=self.config.mv_table_size))
        return UnaryPlan(pin.reader, Fragment(execs), len(execs) - 1,
                         append_only=False)

    # -- aggregation ------------------------------------------------------
    def _has_agg(self, select: ast.Select) -> bool:
        def walk(e) -> bool:
            if isinstance(e, ast.FuncCall):
                if e.name in AGG_NAMES:
                    return True
                return any(walk(a) for a in e.args
                           if not isinstance(a, ast.Star))
            if isinstance(e, ast.BinaryOp):
                return walk(e.left) or walk(e.right)
            if isinstance(e, (ast.UnaryOp, ast.Cast)):
                return walk(e.operand)
            if isinstance(e, ast.Case):
                return any(walk(c) or walk(r) for c, r in e.conditions) or (
                    e.else_result is not None and walk(e.else_result))
            return False

        return any(walk(i.expr) for i in select.items
                   if not isinstance(i.expr, ast.Star))

    def _plan_agg(self, select: ast.Select, scope: Scope,
                  pin: PlannedInput, extra_out: "list | None" = None,
                  eowc: bool = False):
        """The aggregation, its HAVING filter and post-projection; with
        ``extra_out`` (AST expressions in the input scope, aggregates
        allowed) their values are appended to the output as hidden
        columns, and their positions are returned as a fourth element
        (the dynamic filters' left columns)."""
        cfg = self.config
        group_asts = list(select.group_by)
        in_binder = Binder(scope)
        group_by = []
        for gi, ga in enumerate(group_asts):
            name = ga.name if isinstance(ga, ast.ColumnRef) else f"_key{gi}"
            group_by.append((name, in_binder.bind(ga)))
        if not group_by:
            from risingwave_tpu_torch.expr.node import as_expr
            group_by.append(("_global", as_expr(0)))

        item_binder = Binder(scope, allow_aggs=True)
        bound_items: list[tuple[str, Expr]] = []
        for idx, item in enumerate(select.items):
            if isinstance(item.expr, ast.Star):
                raise PlanError("SELECT * with GROUP BY is not valid")
            name = item.alias or self._default_name(item.expr, idx)
            bound_items.append((name, item_binder.bind(item.expr)))
        having_expr = None
        if select.having is not None:
            having_expr = item_binder.bind(select.having)
        extra_bound = [item_binder.bind(e) for e in (extra_out or [])]
        # min/max are distinct-insensitive: DISTINCT on them is dropped
        agg_calls = [dataclasses.replace(a, distinct=False)
                     if a.distinct and a.kind in ("min", "max") else a
                     for a in item_binder.agg_calls]

        # watermark-driven cleaning when a group key is the window start
        wm_idx, lag = None, 0
        if pin.window_size is not None and pin.watermark_col is not None:
            for ki, ga in enumerate(group_asts):
                if isinstance(ga, ast.ColumnRef) and ga.name == "window_start":
                    wm_idx, lag = ki, pin.window_size
                elif isinstance(ga, ast.ColumnRef) and ga.name == "window_end":
                    wm_idx, lag = ki, 0
        if eowc and wm_idx is None:
            raise PlanError(
                "EMIT ON WINDOW CLOSE needs GROUP BY window_start over a "
                "watermarked windowed source")
        # min/max over short strings: the packed int64 monoid (min_str,
        # max_str); wider strings, or a retractable input, would need a
        # materialized-input string state, which the reference lacks too
        for ci, a in enumerate(agg_calls):
            if a.kind in ("min", "max") and a.arg is not None:
                f = a.arg.return_field(scope.schema)
                if f.data_type.is_string:
                    if f.str_width > 8:
                        raise PlanError(
                            f"{a.kind} over strings wider than 8 device "
                            "bytes: next round")
                    if not pin.append_only:
                        raise PlanError(
                            f"{a.kind} over strings on a retractable "
                            "input: next round")
                    agg_calls[ci] = dataclasses.replace(a,
                                                        kind=f"{a.kind}_str")
        agg = HashAggExecutor(
            scope.schema, group_by, agg_calls,
            table_size=cfg.agg_table_size,
            emit_capacity=cfg.agg_emit_capacity,
            watermark_group_idx=wm_idx, watermark_lag=lag,
            watermark_src_col=pin.watermark_col,
            emit_on_window_close=eowc,
            # a retractable input (a join's output, a retract table, the
            # pane plan's global phase) keeps min/max as materialized
            # input (K6m) instead of refusing its deletes
            retractable_input=not pin.append_only,
            minput_bucket_cap=cfg.minput_bucket_cap,
            distinct_table_size=cfg.distinct_table_size,
            # an unbounded key space (no watermark cleaning) diverts the
            # rows its table cannot hold to the host tier; a windowed agg
            # keeps overflow an error (cleaning bounds its state, and
            # freed slots would split a group across the tiers)
            spill_ring=((cfg.agg_spill_ring
                         if cfg.agg_spill_ring is not None
                         else 4 * cfg.chunk_capacity)
                        if wm_idx is None and not eowc else 0))
        agg.spill_table_size = (cfg.agg_spill_table_size
                                or cfg.agg_table_size * 8)
        execs: list[Executor] = [agg]

        rewritten = [(name, self._rewrite_post_agg(e, group_by,
                                                   len(group_by)))
                     for name, e in bound_items]
        selected_keys = {e.index for _, e in rewritten
                         if isinstance(e, InputRef) and e.index < len(group_by)}
        hidden = [(f"_hidden_{agg.out_schema[ki].name}", InputRef(ki))
                  for ki in range(len(group_by)) if ki not in selected_keys]
        proj_items = rewritten + hidden
        extra_pos: list[int] = []
        for xi, xb in enumerate(extra_bound):
            proj_items.append((f"_hidden_dynf{xi}", self._rewrite_post_agg(
                xb, group_by, len(group_by))))
            extra_pos.append(len(proj_items) - 1)
        if having_expr is not None:
            execs.append(FilterExecutor(agg.out_schema, self._rewrite_post_agg(
                having_expr, group_by, len(group_by))))
        post = ProjectExecutor(agg.out_schema, proj_items)
        execs.append(post)
        pk_pos = []
        for ki in range(len(group_by)):
            for pi, (_, e) in enumerate(proj_items):
                if isinstance(e, InputRef) and e.index == ki:
                    pk_pos.append(pi)
                    break
        if extra_out is not None:
            return execs, post.out_schema, pk_pos, extra_pos
        return execs, post.out_schema, pk_pos

    def _rewrite_post_agg(self, e: Expr, group_by, n_keys: int) -> Expr:
        """Rewrite a bound select expr to read the agg output schema."""
        if isinstance(e, AggRef):
            return InputRef(n_keys + e.index)
        for ki, (_, ge) in enumerate(group_by):
            if self._expr_eq(e, ge):
                return InputRef(ki)
        if isinstance(e, InputRef):
            raise PlanError("column referenced outside aggregates must "
                            "appear in GROUP BY")
        if isinstance(e, EFuncCall):
            return EFuncCall(e.name, tuple(
                self._rewrite_post_agg(a, group_by, n_keys) for a in e.args))
        if isinstance(e, ToChar):
            return ToChar(self._rewrite_post_agg(e.arg, group_by, n_keys),
                          e.fmt)
        if isinstance(e, RegexpGroup):
            return RegexpGroup(
                self._rewrite_post_agg(e.arg, group_by, n_keys), e.pattern, 2)
        return e  # literals

    @staticmethod
    def _expr_eq(a: Expr, b: Expr) -> bool:
        from risingwave_tpu_torch.expr.node import Literal as ELit

        if type(a) is not type(b):
            return False
        if isinstance(a, InputRef):
            return a.index == b.index
        if isinstance(a, EFuncCall):
            return a.name == b.name and len(a.args) == len(b.args) and all(
                Planner._expr_eq(x, y) for x, y in zip(a.args, b.args))
        if isinstance(a, ELit):
            return a.value == b.value and a.data_type == b.data_type
        if isinstance(a, ToChar):
            return a.fmt == b.fmt and Planner._expr_eq(a.arg, b.arg)
        if isinstance(a, RegexpGroup):
            return a.pattern == b.pattern and Planner._expr_eq(a.arg, b.arg)
        return False

    def _expand_items(self, items, scope: Scope):
        out = []
        for idx, item in enumerate(items):
            if isinstance(item.expr, ast.Star):
                want = item.expr.table
                if want is not None and want not in scope.qualifiers:
                    raise PlanError(f"table {want!r} in {want}.* not found")
                for ci, f in enumerate(scope.schema):
                    if f.name.startswith("_hidden_"):
                        continue
                    if want is not None and scope.qualifiers[ci] != want:
                        continue
                    out.append((f.name, ast.ColumnRef(f.name,
                                                      scope.qualifiers[ci])))
                continue
            out.append((item.alias or self._default_name(item.expr, idx),
                        item.expr))
        return out

    @staticmethod
    def _bind_order_key(e, binder: Binder, schema: Schema) -> Expr:
        """ORDER BY <n> is positional (postgres); otherwise bind."""
        if isinstance(e, ast.Literal) and e.type_name == "int":
            if not 1 <= e.value <= len(schema):
                raise PlanError(f"ORDER BY position {e.value} out of range")
            return InputRef(e.value - 1)
        return binder.bind(e)

    @staticmethod
    def _default_name(e, idx: int) -> str:
        if isinstance(e, (ast.ColumnRef, ast.FuncCall)):
            return e.name
        return f"col{idx}"
