"""SQL AST nodes.

A copy of ``risingwave_tpu/sql/ast.py``, unchanged except that its imports
name this package: the module imports no JAX, and the port keeps its
own copy instead of importing the reference package.

Reference counterpart: ``src/sqlparser/src/ast/`` — pared down to the
streaming surface this frontend implements.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


# -- expressions ------------------------------------------------------------


@dataclass(frozen=True)
class ColumnRef:
    name: str
    table: str | None = None


@dataclass(frozen=True)
class Literal:
    value: Any
    #: "int" | "float" | "string" | "bool" | "null" | "date" (days
    #: since epoch) | "timestamp" (microseconds since epoch)
    type_name: str


@dataclass(frozen=True)
class IntervalLit:
    micros: int
    #: calendar months (INTERVAL 'n' MONTH/YEAR); not convertible to
    #: micros — consumed by bind-time date-arithmetic folding
    months: int = 0


@dataclass(frozen=True)
class BinaryOp:
    op: str
    left: Any
    right: Any


@dataclass(frozen=True)
class UnaryOp:
    op: str
    operand: Any


@dataclass(frozen=True)
class FuncCall:
    name: str
    args: tuple
    distinct: bool = False
    #: aggregate FILTER (WHERE <cond>) clause (ref agg filter exprs)
    filter_where: "object | None" = None


@dataclass(frozen=True)
class WindowCall:
    """fn(args) OVER (PARTITION BY ... ORDER BY ... [ROWS frame])."""

    name: str
    args: tuple
    partition_by: tuple
    order_by: tuple  # OrderItem
    #: (preceding_rows, following_rows) for ROWS BETWEEN frames;
    #: None = the default frame (unbounded preceding .. current row)
    frame: "tuple | None" = None


@dataclass(frozen=True)
class Cast:
    operand: Any
    type_name: str


@dataclass(frozen=True)
class Case:
    conditions: tuple  # (cond, result) pairs
    else_result: Any


@dataclass(frozen=True)
class Star:
    #: qualified star (``A.*``): expand only that table's columns
    table: "str | None" = None


# -- query ------------------------------------------------------------------


@dataclass(frozen=True)
class SelectItem:
    expr: Any
    alias: str | None


@dataclass(frozen=True)
class TableRef:
    name: str
    alias: str | None = None
    #: ``FOR SYSTEM_TIME AS OF PROCTIME()`` — the build side of a
    #: temporal join (ref temporal_join.rs)
    temporal: bool = False


@dataclass(frozen=True)
class SubqueryRef:
    """A derived table: ``FROM (SELECT ...) alias``."""

    select: "Select"
    alias: str | None = None


@dataclass(frozen=True)
class AlterParallelism:
    """ALTER MATERIALIZED VIEW <name> SET PARALLELISM <n> — online
    rescale at a barrier (ref scale.rs reschedule)."""

    name: str
    parallelism: int


@dataclass(frozen=True)
class CreateFunction:
    """CREATE FUNCTION ... LANGUAGE SQL — inlined at plan time (the
    reference compiles SQL UDFs by inlining too: expr/impl udf)."""

    name: str
    params: tuple           # parameter names, positional
    body_sql: str           # "SELECT <expr>"
    if_not_exists: bool = False


@dataclass(frozen=True)
class InSubquery:
    """``expr [NOT] IN (SELECT ...)`` — planned as a semi/anti join."""

    expr: object
    select: "Select"
    negated: bool = False


@dataclass(frozen=True)
class ExistsSubquery:
    """``EXISTS (SELECT ...)`` — planned as a semi join on the
    correlated equi predicates mined from the subquery's WHERE
    (NOT EXISTS → anti join)."""

    select: "Select"


@dataclass(frozen=True)
class ScalarSubquery:
    """``(SELECT <single aggregate row>)`` in a comparison — planned as
    a dynamic filter against the subquery's 1-row changelog."""

    select: "Select"


@dataclass(frozen=True)
class Tumble:
    """TUMBLE(table, time_col, interval) table function in FROM."""

    table: TableRef
    time_col: str
    size: IntervalLit
    alias: str | None = None


@dataclass(frozen=True)
class Hop:
    """HOP(table, time_col, slide, size)."""

    table: TableRef
    time_col: str
    slide: IntervalLit
    size: IntervalLit
    alias: str | None = None


@dataclass(frozen=True)
class Join:
    left: Any
    right: Any
    on: Any
    kind: str = "inner"


@dataclass(frozen=True)
class OrderItem:
    expr: Any
    descending: bool


@dataclass(frozen=True)
class Select:
    items: tuple[SelectItem, ...]
    from_: Any  # TableRef | Tumble | Hop | Join | None
    where: Any = None
    group_by: tuple = ()
    having: Any = None
    order_by: tuple[OrderItem, ...] = ()
    limit: int | None = None
    offset: int | None = None


# -- statements -------------------------------------------------------------


@dataclass(frozen=True)
class ColumnDef:
    name: str
    type_name: str
    #: columns are NOT NULL by default (deviation from the reference's
    #: nullable default: keeps the non-null fast path for generated
    #: sources); declare ``col type NULL`` to opt in
    nullable: bool = False


@dataclass(frozen=True)
class WatermarkDef:
    column: str
    delay: IntervalLit


@dataclass(frozen=True)
class CreateSource:
    name: str
    columns: tuple[ColumnDef, ...]
    watermark: WatermarkDef | None
    with_options: dict
    if_not_exists: bool = False
    is_table: bool = False
    #: declared PRIMARY KEY column names (metadata; DML tables use it
    #: as the stream key exposed to downstream plans)
    primary_key: tuple = ()


@dataclass(frozen=True)
class Insert:
    table: str
    columns: tuple[str, ...]  # () = positional
    rows: tuple               # tuples of literal AST exprs


@dataclass(frozen=True)
class Delete:
    """``DELETE FROM t VALUES (...)`` — exact-full-row retraction.

    The workload plane knows the full row it retracts (the generator
    keeps deterministic shadow state), so deletes ship the complete
    old row and the changelog simply emits it with ``OP_DELETE`` —
    no lookup path, and every downstream operator retracts by sign
    arithmetic exactly as for any other changelog source."""
    table: str
    columns: tuple[str, ...]  # () = positional
    rows: tuple               # tuples of literal AST exprs


@dataclass(frozen=True)
class Update:
    """``UPDATE t SET col = lit, ... WHERE <full-pk equality>`` —
    workload-plane sugar over the exact-full-row retraction pair: the
    engine resolves the live old row by pk, then desugars to the same
    DELETE+INSERT the generator would have shipped.  Only literal
    assignments and a full-pk equality WHERE are accepted (anything
    else still needs the explicit pair)."""
    table: str
    assignments: tuple  # ((col_name, literal AST expr), ...)
    where: Any = None


@dataclass(frozen=True)
class CreateMaterializedView:
    name: str
    query: Select
    if_not_exists: bool = False
    emit_on_window_close: bool = False
    #: WITH (k = v, ...) between the name and AS — carries the
    #: pushdown plane's ttl option (leading-pk retention horizon)
    with_options: dict = field(default_factory=dict)


@dataclass(frozen=True)
class CreateIndex:
    """``CREATE INDEX name ON mv(col, ...)`` — compiles to a small
    secondary-index MV (pk = (col..., upstream pk)) maintained through
    the MV-on-MV path and exported to the shared serving keyspace."""
    name: str
    table: str
    columns: tuple
    if_not_exists: bool = False


@dataclass(frozen=True)
class CreateSink:
    name: str
    query: Any          # Select (AS form) or None
    from_rel: str | None
    with_options: dict
    if_not_exists: bool = False


@dataclass(frozen=True)
class DropStatement:
    kind: str  # "source" | "materialized view" | "table" | "index"
    name: str
    if_exists: bool = False


@dataclass(frozen=True)
class ShowStatement:
    kind: str  # "sources" | "materialized views" | "tables"


@dataclass(frozen=True)
class FlushStatement:
    pass


@dataclass(frozen=True)
class SetStatement:
    name: str
    value: Any
    system: bool = False  # ALTER SYSTEM SET vs session SET


@dataclass(frozen=True)
class ShowParameters:
    pass


@dataclass(frozen=True)
class DescribeStatement:
    name: str


@dataclass(frozen=True)
class Explain:
    statement: Any
