"""Minimal sqllogictest (.slt) runner.

A copy of ``risingwave_tpu/slt.py`` for the port's ``Engine``, changed
only in its imports (the port's ``DataType``), so that the repository's
``tests/slt/*.slt`` files run against the port.

Reference counterpart: the sqllogictest-rs harness driving
``e2e_test/`` (SURVEY.md §4) — the corpus format is engine-agnostic,
so the same files can exercise this engine.

Supported directives (the subset the reference's streaming tests use):

    statement ok
    <sql>

    statement error [substring]
    <sql>

    query <type-letters> [rowsort]
    <sql>
    ----
    <expected rows, tab- or space-separated>

    sleep <n>ms|s         (mapped to engine ticks: barriers advance time)
    flush                 (FLUSH statement)

Values compare as text after normalization (ints unpadded, floats
rounded to 3 decimals like sqllogictest's convention).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class SltError(AssertionError):
    path: str
    line: int
    message: str

    def __str__(self):
        return f"{self.path}:{self.line}: {self.message}"


def _norm(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "t" if v else "f"
    if isinstance(v, float):
        if v == int(v):
            return str(int(v))
        return f"{v:.3f}"
    s = str(v)
    try:
        f = float(s)
        if "." in s or "e" in s.lower():
            return _norm(f)
    except ValueError:
        pass
    return s


def _render(engine, rows) -> list[tuple]:
    """Type-aware value rendering for comparisons: TIMESTAMP columns
    print as pg text ('2015-07-15 00:00:00.005'), using the serving
    read's bound fields when available."""
    fields = getattr(engine, "_last_fields", None)
    if not fields or not rows:
        return rows
    from risingwave_tpu_torch.common.types import DataType

    ts_cols = [
        i for i, f in enumerate(fields)
        if f.data_type in (DataType.TIMESTAMP, DataType.TIMESTAMPTZ)
    ]
    date_cols = [
        i for i, f in enumerate(fields) if f.data_type == DataType.DATE
    ]
    if not ts_cols and not date_cols:
        return rows
    from datetime import datetime, timedelta

    def fmt_ts(us):
        if us is None:
            return None
        us = int(us)
        dt = datetime(1970, 1, 1) + timedelta(microseconds=us)
        s = dt.replace(microsecond=0).isoformat(sep=" ")
        # fractional seconds render in millisecond groups like the
        # reference ('00:00:20.210', not pg's trimmed '.21'); micro
        # precision extends to 6 digits
        frac = us % 1_000_000
        if frac:
            if frac % 1000 == 0:
                return f"{s}.{frac // 1000:03d}"
            return f"{s}.{frac:06d}"
        return s

    def fmt_date(days):
        if days is None:
            return None
        from datetime import date
        return (date(1970, 1, 1) + timedelta(days=int(days))).isoformat()

    out = []
    for r in rows:
        r = list(r)
        for i in ts_cols:
            r[i] = fmt_ts(r[i])
        for i in date_cols:
            r[i] = fmt_date(r[i])
        out.append(tuple(r))
    return out


def run_slt(engine, path: str, tick_between: int = 1) -> int:
    """Execute an .slt file against an Engine; returns #directives run.

    ``tick_between``: engine barriers advanced after each statement so
    streaming MVs catch up before queries (the reference harness relies
    on wall-clock barrier cadence; ticks are its deterministic analog).
    """
    import os

    with open(path) as f:
        lines = f.read().splitlines()
    i = 0
    n_run = 0
    while i < len(lines):
        line = lines[i].strip()
        if not line or line.startswith("#"):
            i += 1
            continue
        if line.startswith("include "):
            target = line.split(None, 1)[1].strip()
            n_run += run_slt(
                engine,
                os.path.join(os.path.dirname(path), target),
                tick_between=tick_between,
            )
            i += 1
            continue
        if line.startswith("sleep"):
            # barriers are this engine's wall clock: sleep Ns advances N
            # barrier intervals (ms rounds up to one)
            import re as _re

            m = _re.match(r"sleep\s+(\d+)\s*(ms|s)?", line)
            n = int(m.group(1)) if m else 1
            unit = (m.group(2) or "s") if m else "s"
            barriers = max(n if unit == "s" else 1, 1)
            engine.tick(barriers=min(barriers, 60))
            i += 1
            n_run += 1
            continue
        if line == "flush":
            engine.execute("FLUSH")
            i += 1
            n_run += 1
            continue
        if line.startswith("statement"):
            expect_err = "error" in line.split()
            err_sub = line.split("error", 1)[1].strip() if expect_err \
                else None
            sql, i2 = _take_sql(lines, i + 1)
            try:
                engine.execute(sql)
                if expect_err:
                    raise SltError(path, i + 1, "expected an error")
            except SltError:
                raise
            except Exception as e:
                if not expect_err:
                    raise SltError(path, i + 1, f"unexpected error: {e}")
                if err_sub and err_sub not in str(e):
                    raise SltError(
                        path, i + 1,
                        f"error {e!r} does not contain {err_sub!r}",
                    )
            if not expect_err and tick_between and sql.lstrip()[:6].lower() \
                    in ("create", "insert"):
                engine.tick(barriers=tick_between)
            i = i2
            n_run += 1
            continue
        if line.startswith("query"):
            parts = line.split()
            rowsort = "rowsort" in parts
            sql, i2 = _take_sql(lines, i + 1, until="----")
            expected: list[str] = []
            j = i2 + 1  # skip ----
            while j < len(lines) and lines[j].strip():
                expected.append(" ".join(lines[j].split()))
                j += 1
            try:
                rows = engine.execute(sql) or []
            except Exception as e:
                raise SltError(path, i + 1, f"query failed: {e}")
            rows = _render(engine, rows)
            # sqllogictest convention: whitespace inside TEXT values
            # collapses for comparison (the corpus writes rows
            # whitespace-split), so collapse the whole line
            got = [" ".join((" ".join(_norm(v) for v in r)).split())
                   for r in rows]
            # normalize the expected side too: corpus files write floats
            # as e.g. '1.5' while _norm canonicalizes to 3 decimals
            want = [" ".join(_norm(t) for t in row.split())
                    for row in expected]
            if rowsort:
                got, want = sorted(got), sorted(want)
            if got != want:
                raise SltError(
                    path, i + 1,
                    f"mismatch\n  got:  {got}\n  want: {want}",
                )
            i = j
            n_run += 1
            continue
        raise SltError(path, i + 1, f"unknown directive {line!r}")
    return n_run


def _take_sql(lines, i, until=None):
    out = []
    while i < len(lines):
        s = lines[i]
        if until is not None and s.strip() == until:
            break
        if not s.strip():
            break
        out.append(s)
        i += 1
    return "\n".join(out), i
