"""String and calendar kernels K23a-h: wrappers and plain versions.

Port of the device arithmetic of ``risingwave_tpu/expr/scalar.py``'s
string and calendar functions (Nexmark q10, q14, q21 and q22, and the
LIKE, ``substr``, ``trim``, ``concat`` and ``extract`` surface):

- ``str_cmp`` (K23d, ``csrc/str_cmp.cu``): ``_cmp_strs`` (:217) with
  the string branch of ``_make_cmp`` (:241), the six comparisons in one
  kernel;
- ``str_case_map`` (K23d, ``csrc/str_cmp.cu``): ``_lower`` (:438) and
  ``_upper`` (:444);
- ``str_split_part`` (K23a, ``csrc/str_split.cu``): ``_split_part``
  (:748) with ``_match_at`` (:592), ``_greedy_starts`` (:709) and
  ``_cover_mask`` (:734);
- ``to_char`` (K23b, ``csrc/to_char.cu``): ``eval_to_char`` (:857) with
  ``_civil_from_ts`` (:641);
- ``regexp_group`` (K23c, ``csrc/str_regexp.cu``): ``RegexpGroup.eval``
  (:1057);
- ``str_replace`` (K23e, ``csrc/str_replace.cu``): ``_replace`` (:771)
  with ``_greedy_starts`` (:709) and ``_cover_mask`` (:734);
- ``str_match`` and ``like_match`` (K23f, ``csrc/str_match.cu``):
  ``_starts_with`` (:609), ``_ends_with`` (:615) and ``_contains`` (:622)
  over ``_match_at`` (:592), and ``LikePattern.eval`` (:943);
- ``str_substr``, ``str_trim`` and ``str_concat`` (K23g,
  ``csrc/str_window.cu``): ``_substr_window`` (:527), ``_trim_side``
  (:558) and ``_concat`` (:509);
- ``extract`` (K23h, ``csrc/calendar.cu``): ``extract_*`` (:659-701) over
  ``_civil_from_ts`` (:641), and ``_extract_epoch`` (:399, :404).

Each wrapper launches its kernel for CUDA tensors (and raises if it
cannot) and runs the plain version, which repeats the reference's
arithmetic, for CPU tensors.  A string side may be a broadcast literal
(a row of stride 0, as ``Literal.eval`` returns it): the kernels take it
as one row with stride 0, never as a copy per chunk row.

torch's ``//`` and ``%`` on integer tensors floor like jnp's, so the
plain calendar is the reference's line for line; the kernel corrects
CUDA's truncating division (``rw_str.cuh``).  So do they wrap on int64
overflow as jnp does (``substr``'s window arithmetic, ``rw_wrap_add``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from risingwave_tpu_torch import kernels
from risingwave_tpu_torch.common.chunk import StrCol

#: comparison names, in the order of K23d's ``op`` codes
CMP_OPS = ("eq", "ne", "lt", "le", "gt", "ge")


class RwStr(ctypes.Structure):
    """Mirror of ``struct RwStr`` in ``csrc/rw_str.cuh``."""

    _fields_ = [("data", ctypes.c_void_p), ("lens", ctypes.c_void_p),
                ("stride", ctypes.c_longlong),
                ("lens_stride", ctypes.c_longlong), ("width", ctypes.c_int)]


def _rows(t: torch.Tensor):
    """(tensor, row stride in elements): a broadcast row (stride 0) stays
    as it is, anything else is made contiguous."""
    if t.shape[0] > 1 and t.stride(0) == 0 and t[:1].is_contiguous():
        return t, 0
    t = t.contiguous()
    return t, (t[0].numel() if t.dim() > 1 else 1)


def _str_arg(s: StrCol, keep: list) -> RwStr:
    """A string side for a kernel; its tensors are appended to ``keep``
    (alive through the launch, checked by ``require_cuda``)."""
    if s.data.dtype != torch.uint8 or s.lens.dtype != torch.int32:
        raise ValueError("a string side is uint8 bytes with int32 lengths")
    data, ds = _rows(s.data)
    lens, ls = _rows(s.lens)
    keep += [data[:1] if ds == 0 else data, lens[:1] if ls == 0 else lens]
    return RwStr(data.data_ptr(), lens.data_ptr(), ds, ls, data.shape[1])


def _cap(*cols: StrCol) -> int:
    return max(c.lens.shape[0] for c in cols)


def pad_bytes(data: torch.Tensor, w: int) -> torch.Tensor:
    """``[cap, w]`` bytes: ``data`` zero-padded on the right to ``w``."""
    if data.shape[1] == w:
        return data
    out = data.new_zeros((data.shape[0], w))
    out[:, :data.shape[1]] = data
    return out


# ---------------------------------------------------------------------------
# K23d: str_cmp


def str_cmp_plain(a: StrCol, b: StrCol, op: str) -> torch.Tensor:
    """Plain PyTorch version of K23d's comparison: the reference's
    ``_cmp_strs`` (-1 past each length, bytes unsigned) and the first
    differing position."""
    w = max(a.data.shape[1], b.data.shape[1])
    idx = torch.arange(w, device=a.data.device)[None, :]
    av = torch.where(idx < a.lens[:, None],
                     pad_bytes(a.data, w).to(torch.int16), -1)
    bv = torch.where(idx < b.lens[:, None],
                     pad_bytes(b.data, w).to(torch.int16), -1)
    if op == "eq":
        return (av == bv).all(dim=1)
    if op == "ne":
        return (av != bv).any(dim=1)
    neq = av != bv
    any_neq = neq.any(dim=1)
    first = neq.to(torch.uint8).argmax(dim=1, keepdim=True)
    lt = av.gather(1, first)[:, 0] < bv.gather(1, first)[:, 0]
    if op == "lt":
        return any_neq & lt
    if op == "le":
        return ~any_neq | lt
    if op == "gt":
        return any_neq & ~lt
    return ~any_neq | ~lt


def str_cmp_cuda(a: StrCol, b: StrCol, op: str) -> torch.Tensor:
    """K23d (``csrc/str_cmp.cu``, ``rw_str_cmp``): one launch."""
    keep: list = []
    sa, sb = _str_arg(a, keep), _str_arg(b, keep)
    cap = _cap(a, b)
    out = torch.empty(cap, dtype=torch.bool, device=a.data.device)
    kernels.require_cuda("str_cmp", out, *keep)
    fn = kernels.entry("str_cmp", "rw_str_cmp", [
        RwStr, RwStr, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p])
    kernels.count_launch("str_cmp")
    kernels.check(fn(sa, sb, CMP_OPS.index(op), cap, out.data_ptr(),
                     kernels.stream_ptr(out.device)), "str_cmp")
    return out


def str_cmp(a: StrCol, b: StrCol, op: str) -> torch.Tensor:
    """bool [cap]: ``a <op> b`` per row; CUDA tensors launch K23d."""
    impl = str_cmp_cuda if a.data.device.type == "cuda" else str_cmp_plain
    return impl(a, b, op)


# ---------------------------------------------------------------------------
# K23d: str_case_map


def str_case_map_plain(a: StrCol, upper: bool) -> StrCol:
    """Plain PyTorch version of K23d's case map (every byte of the
    width, as the reference maps the whole array)."""
    d = a.data
    if upper:
        hit = (d >= ord("a")) & (d <= ord("z"))
        return StrCol(torch.where(hit, d - 32, d), a.lens)
    hit = (d >= ord("A")) & (d <= ord("Z"))
    return StrCol(torch.where(hit, d + 32, d), a.lens)


def str_case_map_cuda(a: StrCol, upper: bool) -> StrCol:
    """K23d (``csrc/str_cmp.cu``, ``rw_str_case_map``): one launch."""
    keep: list = []
    sa = _str_arg(a, keep)
    cap = _cap(a)
    out = torch.empty((cap, sa.width), dtype=torch.uint8,
                      device=a.data.device)
    kernels.require_cuda("str_case_map", out, *keep)
    fn = kernels.entry("str_case_map", "rw_str_case_map", [
        RwStr, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p])
    kernels.count_launch("str_case_map")
    kernels.check(fn(sa, int(upper), cap, out.data_ptr(),
                     kernels.stream_ptr(out.device)), "str_case_map")
    return StrCol(out, a.lens)


def str_case_map(a: StrCol, upper: bool) -> StrCol:
    """``upper(a)`` or ``lower(a)`` over ASCII; CUDA tensors launch K23d."""
    impl = str_case_map_cuda if a.data.device.type == "cuda" \
        else str_case_map_plain
    return impl(a, upper)


# ---------------------------------------------------------------------------
# K23a: split_part


def _match_at(a: StrCol, p: StrCol, offsets: torch.Tensor) -> torch.Tensor:
    """bool [cap, n_off]: ``p`` occurs in ``a`` at each offset (the
    reference's ``_match_at``: a pattern byte past the pattern's length
    matches anything, a string byte past the string's length nothing)."""
    wa = a.data.shape[1]
    alen = a.lens.to(torch.int64)[:, None]
    plen = p.lens.to(torch.int64)[:, None]
    offsets = offsets.to(torch.int64)
    data = a.data.expand(offsets.shape[0], wa)
    ok = torch.ones(offsets.shape, dtype=torch.bool, device=a.data.device)
    for j in range(p.data.shape[1]):
        src = offsets + j
        got = data.gather(1, torch.clamp(src, 0, wa - 1))
        ok &= ((got == p.data[:, j:j + 1]) & (src < alen)) | (j >= plen)
    return ok


def _greedy_starts(a: StrCol, p: StrCol) -> torch.Tensor:
    """[cap, wa] bool: the leftmost non-overlapping match starts of ``p``
    in ``a`` (``_match_at`` at every offset, then the reference's scan:
    after a match the cursor jumps past it)."""
    cap, wa = a.data.shape
    dev = a.data.device
    alen = a.lens.to(torch.int64)[:, None]
    plen = p.lens.to(torch.int64)[:, None]
    offs = torch.arange(wa, device=dev).expand(cap, wa)
    hits = _match_at(a, p, offs) & (offs <= alen - plen) & (plen > 0)
    sel = torch.zeros((cap, wa), dtype=torch.bool, device=dev)
    next_ok = torch.zeros(cap, dtype=torch.int64, device=dev)
    for b in range(wa):
        s = hits[:, b] & (b >= next_ok)
        sel[:, b] = s
        next_ok = torch.where(s, b + plen[:, 0], next_ok)
    return sel


def _cover_mask(sel: torch.Tensor, span_lens: torch.Tensor) -> torch.Tensor:
    """[cap, wa] bool: bytes covered by the ``[start, start + len)``
    spans starting where ``sel`` is set."""
    cap, wa = sel.shape
    cols = torch.arange(wa, device=sel.device).expand(cap, wa)
    s = sel.to(torch.int32)
    delta = torch.zeros((cap, wa + 1), dtype=torch.int32, device=sel.device)
    delta.scatter_add_(1, cols, s)
    ends = torch.clamp(cols + span_lens.to(torch.int64)[:, None], 0, wa)
    delta.scatter_add_(1, ends, -s)
    return torch.cumsum(delta[:, :wa], dim=1) > 0


def str_split_part_plain(a: StrCol, delim: StrCol,
                         n: torch.Tensor) -> StrCol:
    """Plain PyTorch version of K23a: the reference's ``_split_part``
    (part index of each byte = delimiters ended before it; the target
    part's bytes compacted to offset 0)."""
    cap, wa = a.data.shape
    dev = a.data.device
    sel = _greedy_starts(a, delim)
    in_delim = _cover_mask(sel, delim.lens)
    cols = torch.arange(wa, device=dev).expand(cap, wa)
    si = sel.to(torch.int64)
    part_id = torch.cumsum(si, dim=1) - si
    n_parts = si.sum(dim=1) + 1
    n = n.to(torch.int32).to(torch.int64)
    target = torch.where(n > 0, n - 1, n_parts + n)
    keep = (part_id == target[:, None]) & ~in_delim \
        & (cols < a.lens[:, None])
    ki = keep.to(torch.int64)
    pos = torch.cumsum(ki, dim=1) - ki
    out = torch.zeros((cap, wa + 1), dtype=torch.uint8, device=dev)
    out.scatter_(1, torch.where(keep, pos, wa), a.data.expand(cap, wa))
    return StrCol(out[:, :wa].contiguous(), ki.sum(dim=1).to(torch.int32))


def str_split_part_cuda(a: StrCol, delim: StrCol,
                        n: torch.Tensor) -> StrCol:
    """K23a (``csrc/str_split.cu``, ``rw_split_part``): one launch."""
    keep: list = []
    sa, sd = _str_arg(a, keep), _str_arg(delim, keep)
    nth, ns = _rows(n.to(torch.int32))
    keep.append(nth[:1] if ns == 0 else nth)
    cap = _cap(a, delim)
    dev = a.data.device
    out = torch.empty((cap, sa.width), dtype=torch.uint8, device=dev)
    out_len = torch.empty(cap, dtype=torch.int32, device=dev)
    kernels.require_cuda("str_split_part", out, out_len, *keep)
    fn = kernels.entry("str_split_part", "rw_split_part", [
        RwStr, RwStr, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    kernels.count_launch("str_split_part")
    kernels.check(fn(sa, sd, nth.data_ptr(), ns, cap, out.data_ptr(),
                     out_len.data_ptr(), kernels.stream_ptr(dev)),
                  "str_split_part")
    return StrCol(out, out_len)


def str_split_part(a: StrCol, delim: StrCol, n: torch.Tensor) -> StrCol:
    """``split_part(a, delim, n)`` at ``a``'s width; CUDA tensors launch
    K23a."""
    impl = str_split_part_cuda if a.data.device.type == "cuda" \
        else str_split_part_plain
    return impl(a, delim, n)


# ---------------------------------------------------------------------------
# K23b: to_char

#: to_char components, in the order of K23b's codes (1-based; 0 is a
#: literal run)
TO_CHAR_COMPONENTS = ("year", "year2", "month", "day", "hour24", "hour12",
                      "minute", "second", "milli", "micro", "meridiem_upper",
                      "meridiem_lower")
#: most segments and literal bytes of a program (``RW_TOCHAR_*``)
TO_CHAR_SEGS, TO_CHAR_LIT = 32, 128


def civil_from_ts(us: torch.Tensor):
    """(year, month, day) of int64 microsecond timestamps: the
    reference's ``_civil_from_ts`` (floor division throughout)."""
    days = us // 86_400_000_000
    z = days + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def to_char_plain(ts: torch.Tensor, segs: list) -> StrCol:
    """Plain PyTorch version of K23b: the reference's ``eval_to_char``
    over a compiled format (``[("lit", bytes) | ("field", (component,
    digits))]``)."""
    cap = ts.shape[0]
    dev = ts.device
    ts = ts.to(torch.int64)
    y, m, d = civil_from_ts(ts)
    in_day = ts % 86_400_000_000
    comp = {
        "year": y, "year2": y % 100, "month": m, "day": d,
        "hour24": in_day // 3_600_000_000,
        "minute": (in_day // 60_000_000) % 60,
        "second": (in_day // 1_000_000) % 60,
        "milli": (in_day // 1_000) % 1000,
        "micro": in_day % 1_000_000,
    }
    comp["hour12"] = (comp["hour24"] + 11) % 12 + 1
    parts = []
    for kind, payload in segs:
        if kind == "lit":
            row = torch.tensor(list(payload), dtype=torch.uint8, device=dev)
            parts.append(row.expand(cap, -1))
            continue
        name, w = payload
        if name.startswith("meridiem"):
            am, pm = (b"AM", b"PM") if name.endswith("upper") \
                else (b"am", b"pm")
            rows = torch.tensor([list(am), list(pm)], dtype=torch.uint8,
                                device=dev)
            parts.append(rows[(comp["hour24"] >= 12).to(torch.int64)])
            continue
        v = comp[name]
        parts.append(torch.stack(
            [(v // 10 ** (w - 1 - j)) % 10 + ord("0") for j in range(w)],
            dim=1).to(torch.uint8))
    data = torch.cat(parts, dim=1)
    return StrCol(data, torch.full((cap,), data.shape[1], dtype=torch.int32,
                                   device=dev))


class ToCharProg(ctypes.Structure):
    """Mirror of ``struct ToCharProg`` in ``csrc/to_char.cu``."""

    _fields_ = [("n", ctypes.c_int), ("width", ctypes.c_int),
                ("kind", ctypes.c_int * TO_CHAR_SEGS),
                ("arg", ctypes.c_int * TO_CHAR_SEGS),
                ("len", ctypes.c_int * TO_CHAR_SEGS),
                ("lit", ctypes.c_ubyte * TO_CHAR_LIT)]


def to_char_refusal(segs: tuple) -> str | None:
    """Why K23b cannot take a compiled format, or None."""
    if len(segs) > TO_CHAR_SEGS:
        return f"to_char format of {len(segs)} segments: K23b takes " \
            f"{TO_CHAR_SEGS}"
    n = sum(len(x) for k, x in segs if k == "lit")
    if n > TO_CHAR_LIT:
        return f"to_char format of {n} literal bytes: K23b takes " \
            f"{TO_CHAR_LIT}"
    return None


@functools.lru_cache(maxsize=64)
def to_char_program(segs: tuple) -> ToCharProg:
    """K23b's segment program of a compiled format (built once per
    format); raises when it outgrows the program's fixed size."""
    why = to_char_refusal(segs)
    if why is not None:
        raise ValueError(why)
    prog = ToCharProg()
    prog.n = len(segs)
    lit = b""
    width = 0
    for s, (kind, payload) in enumerate(segs):
        if kind == "lit":
            prog.kind[s], prog.arg[s], prog.len[s] = 0, len(lit), len(payload)
            lit += payload
            width += len(payload)
        else:
            name, w = payload
            prog.kind[s] = TO_CHAR_COMPONENTS.index(name) + 1
            prog.arg[s] = w
            width += w
    prog.lit[:len(lit)] = list(lit)
    prog.width = width
    return prog


def to_char_cuda(ts: torch.Tensor, segs: list) -> StrCol:
    """K23b (``csrc/to_char.cu``, ``rw_to_char``): one launch."""
    prog = to_char_program(tuple(segs))
    ts = ts.to(torch.int64).contiguous()
    cap = ts.shape[0]
    out = torch.empty((cap, prog.width), dtype=torch.uint8, device=ts.device)
    kernels.require_cuda("to_char", ts, out)
    fn = kernels.entry("to_char", "rw_to_char", [
        ctypes.c_void_p, ctypes.c_longlong, ToCharProg, ctypes.c_void_p,
        ctypes.c_void_p])
    kernels.count_launch("to_char")
    kernels.check(fn(ts.data_ptr(), cap, prog, out.data_ptr(),
                     kernels.stream_ptr(ts.device)), "to_char")
    return StrCol(out, torch.full((cap,), prog.width, dtype=torch.int32,
                                  device=ts.device))


def to_char(ts: torch.Tensor, segs: list) -> StrCol:
    """Format int64 microsecond timestamps by a compiled format at its
    fixed width; CUDA tensors launch K23b."""
    impl = to_char_cuda if ts.device.type == "cuda" else to_char_plain
    return impl(ts, segs)


# ---------------------------------------------------------------------------
# K23c: regexp_group


def regexp_group_plain(s: StrCol, lit: torch.Tensor, guard: int,
                       stop: int):
    """Plain PyTorch version of K23c: the reference's
    ``RegexpGroup.eval`` without its null mask.  ``lit`` is the literal's
    bytes (uint8 [L]), ``guard`` the guard byte or -1, ``stop`` the stop
    byte.  Returns (StrCol at ``s``'s width, found bool [cap])."""
    cap, w = s.data.shape
    dev = s.data.device
    n_lit = lit.shape[0]
    data = s.data.to(torch.int32)
    slen = s.lens.to(torch.int64)[:, None]
    offs = torch.arange(w, device=dev)[None, :]
    hits = offs <= slen - n_lit
    for j in range(n_lit):
        src = offs + j
        got = data[:, torch.clamp(src, max=w - 1)[0]]
        hits &= (got == lit[j].to(torch.int32)) & (src < slen)
    if guard >= 0:
        prev = data[:, torch.clamp(offs - 1, 0, w - 1)[0]]
        hits &= (offs == 0) | (prev == guard)
    found = hits.any(dim=1)
    first = hits.to(torch.uint8).argmax(dim=1)
    start = (first + n_lit)[:, None]
    src = torch.clamp(offs + start, 0, w - 1)
    shifted = data.gather(1, src)
    is_stop = (shifted == stop) & (offs + start < slen)
    any_stop = is_stop.any(dim=1)
    stop_at = is_stop.to(torch.uint8).argmax(dim=1)
    lens = torch.where(any_stop, stop_at,
                       torch.clamp(slen[:, 0] - start[:, 0], min=0))
    lens = torch.where(found, torch.clamp(lens, min=0), 0)
    out = torch.where(offs < lens[:, None], shifted, 0).to(torch.uint8)
    return StrCol(out, lens.to(torch.int32)), found


def regexp_group_cuda(s: StrCol, lit: torch.Tensor, guard: int, stop: int):
    """K23c (``csrc/str_regexp.cu``, ``rw_regexp_group``): one launch."""
    keep: list = []
    ss = _str_arg(s, keep)
    cap = _cap(s)
    dev = s.data.device
    lit = lit.contiguous()
    out = torch.empty((cap, ss.width), dtype=torch.uint8, device=dev)
    out_len = torch.empty(cap, dtype=torch.int32, device=dev)
    found = torch.empty(cap, dtype=torch.bool, device=dev)
    kernels.require_cuda("regexp_group", lit, out, out_len, found, *keep)
    fn = kernels.entry("regexp_group", "rw_regexp_group", [
        RwStr, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p])
    kernels.count_launch("regexp_group")
    kernels.check(fn(ss, lit.data_ptr(), lit.shape[0], guard, stop, cap,
                     out.data_ptr(), out_len.data_ptr(), found.data_ptr(),
                     kernels.stream_ptr(dev)), "regexp_group")
    return StrCol(out, out_len), found


def regexp_group(s: StrCol, lit: torch.Tensor, guard: int, stop: int):
    """The ``(guard|^)lit([^stop]*)`` capture of each row and whether the
    row matched; CUDA tensors launch K23c."""
    impl = regexp_group_cuda if s.data.device.type == "cuda" \
        else regexp_group_plain
    return impl(s, lit, guard, stop)


# ---------------------------------------------------------------------------
# K23e: replace


def str_replace_plain(a: StrCol, frm: StrCol, to: StrCol) -> StrCol:
    """Plain PyTorch version of K23e: the reference's ``_replace`` (the
    greedy match starts, each byte's output position as an exclusive
    prefix sum of what it emits, the replacement spans forward-filled in
    output space), clamped at ``a``'s width."""
    cap, wa = a.data.shape
    dev = a.data.device
    sel = _greedy_starts(a, frm)
    in_from = _cover_mask(sel, frm.lens)
    cols = torch.arange(wa, device=dev).expand(cap, wa)
    in_str = cols < a.lens.to(torch.int64)[:, None]
    tl = to.lens.to(torch.int64)[:, None].expand(cap, wa)
    emit = torch.where(sel, tl, (~(in_from | ~in_str)).to(torch.int64))
    start = torch.cumsum(emit, dim=1) - emit
    out_len = torch.clamp(start[:, -1] + emit[:, -1], max=wa)
    normal = in_str & ~in_from
    out = torch.zeros((cap, wa + 1), dtype=torch.uint8, device=dev)
    out.scatter_(1, torch.where(normal, torch.clamp(start, max=wa), wa),
                 a.data.expand(cap, wa))
    out_sel = torch.zeros((cap, wa + 1), dtype=torch.bool, device=dev)
    out_sel.scatter_(1, torch.where(sel, torch.clamp(start, max=wa), wa),
                     True)
    out_sel = out_sel[:, :wa]
    base = torch.cummax(torch.where(out_sel, cols, -1), dim=1).values
    in_to = _cover_mask(out_sel, to.lens)
    wt = to.data.shape[1]
    off = torch.clamp(cols - base, 0, wt - 1)
    to_bytes = to.data.expand(cap, wt).gather(1, off)
    data = torch.where(in_to & (base >= 0), to_bytes, out[:, :wa])
    keep = cols < out_len[:, None]
    return StrCol(torch.where(keep, data, 0).to(torch.uint8),
                  out_len.to(torch.int32))


def str_replace_cuda(a: StrCol, frm: StrCol, to: StrCol) -> StrCol:
    """K23e (``csrc/str_replace.cu``, ``rw_replace``): one launch."""
    keep: list = []
    sa, sf, st = _str_arg(a, keep), _str_arg(frm, keep), _str_arg(to, keep)
    cap = _cap(a, frm, to)
    dev = a.data.device
    out = torch.empty((cap, sa.width), dtype=torch.uint8, device=dev)
    out_len = torch.empty(cap, dtype=torch.int32, device=dev)
    kernels.require_cuda("str_replace", out, out_len, *keep)
    fn = kernels.entry("str_replace", "rw_replace", [
        RwStr, RwStr, RwStr, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p])
    kernels.count_launch("str_replace")
    kernels.check(fn(sa, sf, st, cap, out.data_ptr(), out_len.data_ptr(),
                     kernels.stream_ptr(dev)), "str_replace")
    return StrCol(out, out_len)


def str_replace(a: StrCol, frm: StrCol, to: StrCol) -> StrCol:
    """``replace(a, frm, to)`` at ``a``'s width (longer output
    truncates); CUDA tensors launch K23e."""
    impl = str_replace_cuda if a.data.device.type == "cuda" \
        else str_replace_plain
    return impl(a, frm, to)


# ---------------------------------------------------------------------------
# K23f: starts_with, ends_with, contains, LIKE

#: str_match's modes, in the order of K23f's ``mode`` codes
MATCH_MODES = ("starts_with", "ends_with", "contains")
#: most segments and pattern bytes of a LIKE program (``RW_LIKE_*``)
LIKE_SEGS, LIKE_BYTES = 16, 256


def str_match_plain(a: StrCol, p: StrCol, mode: str) -> torch.Tensor:
    """Plain PyTorch version of K23f's ``str_match``: the reference's
    ``_starts_with``, ``_ends_with`` and ``_contains``."""
    cap, wa = a.data.shape
    dev = a.data.device
    fits = p.lens <= a.lens
    if mode == "starts_with":
        zero = torch.zeros((cap, 1), dtype=torch.int64, device=dev)
        return _match_at(a, p, zero)[:, 0] & fits
    if mode == "ends_with":
        off = (a.lens.to(torch.int64) - p.lens.to(torch.int64))[:, None]
        return _match_at(a, p, torch.clamp(off, min=0))[:, 0] & fits
    offs = torch.arange(wa, device=dev).expand(cap, wa)
    hits = _match_at(a, p, offs)
    last = (a.lens.to(torch.int64) - p.lens.to(torch.int64))[:, None]
    return (hits & (offs <= last)).any(dim=1) & fits


def str_match_cuda(a: StrCol, p: StrCol, mode: str) -> torch.Tensor:
    """K23f (``csrc/str_match.cu``, ``rw_str_match``): one launch."""
    keep: list = []
    sa, sp = _str_arg(a, keep), _str_arg(p, keep)
    cap = _cap(a, p)
    out = torch.empty(cap, dtype=torch.bool, device=a.data.device)
    kernels.require_cuda("str_match", out, *keep)
    fn = kernels.entry("str_match", "rw_str_match", [
        RwStr, RwStr, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p])
    kernels.count_launch("str_match")
    kernels.check(fn(sa, sp, MATCH_MODES.index(mode), cap, out.data_ptr(),
                     kernels.stream_ptr(out.device)), "str_match")
    return out


def str_match(a: StrCol, p: StrCol, mode: str) -> torch.Tensor:
    """bool [cap]: ``mode`` (starts_with, ends_with or contains) of ``p``
    in ``a`` per row; CUDA tensors launch K23f."""
    impl = str_match_cuda if a.data.device.type == "cuda" \
        else str_match_plain
    return impl(a, p, mode)


def like_match_plain(a: StrCol, segs: tuple, anchor_start: bool,
                     anchor_end: bool) -> torch.Tensor:
    """Plain PyTorch version of K23f's LIKE: the reference's
    ``LikePattern.eval`` over the pattern's non-empty ``%``-separated
    segments (bytes), leftmost first, the cursor moving past each."""
    cap, wa = a.data.shape
    dev = a.data.device
    if not segs:
        return torch.ones(cap, dtype=torch.bool, device=dev)
    alen = a.lens.to(torch.int64)
    zero = torch.zeros((cap, 1), dtype=torch.int64, device=dev)

    def const(seg: bytes) -> StrCol:
        row = torch.tensor(list(seg), dtype=torch.uint8, device=dev)
        return StrCol(row.expand(cap, -1),
                      torch.full((cap,), len(seg), dtype=torch.int32,
                                 device=dev))

    if len(segs) == 1 and anchor_start and anchor_end:
        return _match_at(a, const(segs[0]), zero)[:, 0] \
            & (alen == len(segs[0]))
    ok = torch.ones(cap, dtype=torch.bool, device=dev)
    pos = torch.zeros(cap, dtype=torch.int64, device=dev)
    offs = torch.arange(wa, device=dev).expand(cap, wa)
    for k, seg in enumerate(segs):
        pat, n = const(seg), len(seg)
        if k == 0 and anchor_start:
            ok &= _match_at(a, pat, zero)[:, 0] & (n <= alen)
            pos = torch.full_like(pos, n)
            continue
        if k == len(segs) - 1 and anchor_end:
            off = alen - n
            ok &= _match_at(a, pat, torch.clamp(off, min=0)[:, None])[:, 0] \
                & (off >= pos)
            continue
        hits = _match_at(a, pat, offs) & (offs >= pos[:, None]) \
            & (offs <= (alen - n)[:, None])
        ok &= hits.any(dim=1)
        pos = hits.to(torch.uint8).argmax(dim=1) + n
    return ok


class LikeProg(ctypes.Structure):
    """Mirror of ``struct LikeProg`` in ``csrc/str_match.cu``."""

    _fields_ = [("n", ctypes.c_int), ("anchor_start", ctypes.c_int),
                ("anchor_end", ctypes.c_int),
                ("off", ctypes.c_int * LIKE_SEGS),
                ("len", ctypes.c_int * LIKE_SEGS),
                ("bytes", ctypes.c_ubyte * LIKE_BYTES)]


def like_refusal(segs: tuple) -> str | None:
    """Why K23f cannot take a LIKE pattern of these segments, or None."""
    if len(segs) > LIKE_SEGS:
        return f"a LIKE pattern of {len(segs)} segments (K23f takes " \
            f"{LIKE_SEGS})"
    n = sum(len(x) for x in segs)
    if n > LIKE_BYTES:
        return f"a LIKE pattern of {n} literal bytes (K23f takes " \
            f"{LIKE_BYTES})"
    return None


@functools.lru_cache(maxsize=64)
def like_program(segs: tuple, anchor_start: bool,
                 anchor_end: bool) -> LikeProg:
    """K23f's LIKE program of a compiled pattern (built once per
    pattern); raises when it outgrows the program's fixed size."""
    why = like_refusal(segs)
    if why is not None:
        raise ValueError(why)
    prog = LikeProg()
    prog.n = len(segs)
    prog.anchor_start, prog.anchor_end = int(anchor_start), int(anchor_end)
    data = b""
    for k, seg in enumerate(segs):
        prog.off[k], prog.len[k] = len(data), len(seg)
        data += seg
    prog.bytes[:len(data)] = list(data)
    return prog


def like_match_cuda(a: StrCol, segs: tuple, anchor_start: bool,
                    anchor_end: bool) -> torch.Tensor:
    """K23f (``csrc/str_match.cu``, ``rw_like``): one launch."""
    prog = like_program(tuple(segs), anchor_start, anchor_end)
    keep: list = []
    sa = _str_arg(a, keep)
    cap = _cap(a)
    out = torch.empty(cap, dtype=torch.bool, device=a.data.device)
    kernels.require_cuda("str_match", out, *keep)
    fn = kernels.entry("str_match", "rw_like", [
        RwStr, LikeProg, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p])
    kernels.count_launch("str_match")
    kernels.check(fn(sa, prog, cap, out.data_ptr(),
                     kernels.stream_ptr(out.device)), "str_match")
    return out


def like_match(a: StrCol, segs: tuple, anchor_start: bool,
               anchor_end: bool) -> torch.Tensor:
    """bool [cap]: ``a`` LIKE the ``%``-only pattern of ``segs`` (its
    non-empty segments' bytes); CUDA tensors launch K23f."""
    impl = like_match_cuda if a.data.device.type == "cuda" \
        else like_match_plain
    return impl(a, segs, anchor_start, anchor_end)


# ---------------------------------------------------------------------------
# K23g: substr, trim, concat

#: str_window's modes, in the order of K23g's ``mode`` codes
WINDOW_MODES = ("substr", "ltrim", "rtrim", "trim", "concat")


def _window_plain(a: StrCol, lo: torch.Tensor, lens: torch.Tensor) -> StrCol:
    """``a``'s bytes ``[lo, lo + lens)`` from offset 0, zero past ``lens``
    (the reference's clipped take)."""
    cap, w = a.data.shape
    idx = torch.arange(w, device=a.data.device)[None, :]
    src = torch.clamp(idx + lo[:, None], 0, w - 1)
    data = a.data.expand(cap, w).gather(1, src)
    return StrCol(torch.where(idx < lens[:, None], data, 0).to(torch.uint8),
                  lens)


def str_substr_plain(a: StrCol, start: torch.Tensor,
                     count: torch.Tensor | None = None) -> StrCol:
    """Plain PyTorch version of K23g's substr: the reference's
    ``_substr_window`` (PostgreSQL's window from the given, possibly
    non-positive, position)."""
    w = a.data.shape[1]
    s0 = start.to(torch.int64) - 1
    if count is None:
        end = torch.full_like(s0, w)
    else:
        end = s0 + torch.clamp(count.to(torch.int64), min=0)
    lo = torch.clamp(s0, min=0)
    hi = torch.minimum(end, a.lens.to(torch.int64))
    lens = torch.clamp(hi - lo, min=0).to(torch.int32)
    return _window_plain(a, lo, lens)


def str_trim_plain(a: StrCol, mode: str) -> StrCol:
    """Plain PyTorch version of K23g's trims: the reference's
    ``_trim_side`` (``mode`` ltrim, rtrim or trim)."""
    cap, w = a.data.shape
    left, right = mode in ("ltrim", "trim"), mode in ("rtrim", "trim")
    idx = torch.arange(w, device=a.data.device)[None, :]
    in_str = idx < a.lens[:, None]
    nonsp = in_str & (a.data != ord(" "))
    any_nonsp = nonsp.any(dim=1)
    first = nonsp.to(torch.uint8).argmax(dim=1)
    last = w - 1 - nonsp.flip(1).to(torch.uint8).argmax(dim=1)
    zero = torch.zeros_like(first)
    s0 = torch.where(any_nonsp, first if left else zero, zero)
    e0 = torch.where(any_nonsp, (last + 1) if right
                     else a.lens.to(torch.int64), zero)
    lens = torch.clamp(e0 - s0, min=0).to(torch.int32)
    return _window_plain(a, s0, lens)


def str_concat_plain(a: StrCol, b: StrCol) -> StrCol:
    """Plain PyTorch version of K23g's concat: the reference's
    ``_concat`` (width ``wa + wb``)."""
    cap = _cap(a, b)
    wa, wb = a.data.shape[1], b.data.shape[1]
    idx = torch.arange(wa + wb, device=a.data.device).expand(cap, wa + wb)
    la = a.lens.to(torch.int64)[:, None]
    from_a = idx < la
    got_a = a.data.expand(cap, wa).gather(1, torch.clamp(idx, 0, wa - 1))
    got_b = b.data.expand(cap, wb).gather(1, torch.clamp(idx - la, 0,
                                                         wb - 1))
    lens = a.lens + b.lens
    data = torch.where(from_a, got_a, got_b)
    return StrCol(torch.where(idx < lens[:, None], data, 0).to(torch.uint8),
                  lens.to(torch.int32))


def str_window_cuda(a: StrCol, mode: str, b: StrCol | None = None,
                    start: torch.Tensor | None = None,
                    count: torch.Tensor | None = None) -> StrCol:
    """K23g (``csrc/str_window.cu``, ``rw_str_window``): one launch."""
    keep: list = []
    sa = _str_arg(a, keep)
    sb = _str_arg(b, keep) if b is not None else sa
    cap = _cap(a, b) if b is not None else _cap(a)
    dev = a.data.device
    args = []
    for t in (start, count):
        if t is None:
            args += [None, 0]
            continue
        t, ts = _rows(t.to(torch.int64))
        keep.append(t[:1] if ts == 0 else t)
        args += [t.data_ptr(), ts]
    width = sa.width + (sb.width if mode == "concat" else 0)
    out = torch.empty((cap, width), dtype=torch.uint8, device=dev)
    out_len = torch.empty(cap, dtype=torch.int32, device=dev)
    kernels.require_cuda("str_window", out, out_len, *keep)
    fn = kernels.entry("str_window", "rw_str_window", [
        RwStr, RwStr, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    kernels.count_launch("str_window")
    kernels.check(fn(sa, sb, *args, WINDOW_MODES.index(mode), cap, width,
                     out.data_ptr(), out_len.data_ptr(),
                     kernels.stream_ptr(dev)), "str_window")
    return StrCol(out, out_len)


def str_substr(a: StrCol, start: torch.Tensor,
               count: torch.Tensor | None = None) -> StrCol:
    """``substr(a, start[, count])`` at ``a``'s width; CUDA tensors
    launch K23g."""
    if a.data.device.type == "cuda":
        return str_window_cuda(a, "substr", start=start, count=count)
    return str_substr_plain(a, start, count)


def str_trim(a: StrCol, mode: str) -> StrCol:
    """``trim``, ``ltrim`` or ``rtrim`` of spaces at ``a``'s width; CUDA
    tensors launch K23g."""
    if a.data.device.type == "cuda":
        return str_window_cuda(a, mode)
    return str_trim_plain(a, mode)


def str_concat(a: StrCol, b: StrCol) -> StrCol:
    """``a || b`` at the sum of the two widths; CUDA tensors launch
    K23g."""
    if a.data.device.type == "cuda":
        return str_window_cuda(a, "concat", b=b)
    return str_concat_plain(a, b)


# ---------------------------------------------------------------------------
# K23h: extract

#: extract's parts, in the order of K23h's ``part`` codes
EXTRACT_PARTS = ("year", "month", "day", "hour", "minute", "second", "dow",
                 "doy", "epoch")
DAY_US = 86_400_000_000


def extract_plain(x: torch.Tensor, part: str, date: bool) -> torch.Tensor:
    """Plain PyTorch version of K23h: the reference's ``_mk_extract``
    (a DATE's int32 days taken as days x 86400e6 microseconds, as
    ``_mk_extract_date`` does) and ``_extract_epoch``; int64 out."""
    if part == "epoch":
        return x.to(torch.int64) * 86_400 if date else x // 1_000_000
    ts = x.to(torch.int64) * DAY_US if date else x
    if part in ("year", "month", "day", "dow", "doy"):
        y, m, d = civil_from_ts(ts)
        if part == "year":
            return y
        if part == "month":
            return m
        if part == "day":
            return d
        days = ts // DAY_US
        if part == "dow":
            return (days + 4) % 7
        yy = y - 1
        days_jan1 = (yy * 365 + yy // 4 - yy // 100 + yy // 400) - 719162
        return (days - days_jan1 + 1).to(torch.int64)
    in_day = ts % DAY_US
    if part == "hour":
        return in_day // 3_600_000_000
    if part == "minute":
        return (in_day // 60_000_000) % 60
    return (in_day // 1_000_000) % 60


def extract_cuda(x: torch.Tensor, part: str, date: bool) -> torch.Tensor:
    """K23h (``csrc/calendar.cu``, ``rw_calendar``): one launch."""
    x = x.to(torch.int32 if date else torch.int64).contiguous()
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    kernels.require_cuda("calendar", x, out)
    fn = kernels.entry("calendar", "rw_calendar", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p])
    kernels.count_launch("calendar")
    kernels.check(fn(x.data_ptr(), int(date), EXTRACT_PARTS.index(part),
                     x.shape[0], out.data_ptr(),
                     kernels.stream_ptr(x.device)), "calendar")
    return out


def extract(x: torch.Tensor, part: str, date: bool = False) -> torch.Tensor:
    """int64 [cap]: ``extract(part FROM x)`` of int64 microsecond
    timestamps (or int32 days with ``date``); CUDA tensors launch K23h."""
    impl = extract_cuda if x.device.type == "cuda" else extract_plain
    return impl(x, part, date)
