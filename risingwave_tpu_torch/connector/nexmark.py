"""Nexmark event generator on the device.

Port of ``risingwave_tpu/connector/nexmark.py``: every field of an
event is a counter-based hash of (event id, field stream), so a chunk is
a pure function of its first ordinal and generates on the device in one
pass.  The same ``(k0, cap)`` gives the same columns as the reference.
On the card each generator is one launch of kernel K9: ``gen_bids``
(``csrc/nexmark_bids.cu``), ``gen_auctions`` and ``gen_persons``
(``csrc/nexmark_events.cu``); the ``*_plain`` methods are their plain
versions, passes of elementwise torch ops.  Auctions and persons take
the list of columns a source keeps (``cols``, in output order), and the
kernels generate only those.

PyTorch has no uint64 ``%`` or ``>>``, so the generator computes in
int64: logical shifts mask the sign extension, and the unsigned modulo
of a 64-bit pattern ``x`` by a positive ``b`` is
``((x >>> 1) % b * 2 + (x & 1)) % b``.  ``_next_price`` is
``round(10**(u*6) * 100)`` in float64; its last bits may differ from
the reference's ``pow`` on some inputs, but not after the rounding (the
CPU tests check that over a million event ids).

Event layout per 50-event epoch (canonical proportions 1:3:46):
offset 0 -> Person, 1..3 -> Auction, 4..49 -> Bid.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from fractions import Fraction
from typing import Sequence

import torch

from risingwave_tpu_torch import kernels
from risingwave_tpu_torch.common.chunk import Chunk, StrCol, encode_strings
from risingwave_tpu_torch.common.device import resolve_device
from risingwave_tpu_torch.common.hash import K1, K3, mix64, srl
from risingwave_tpu_torch.common.types import DataType, Field, Schema

PERSON_PROPORTION = 1
AUCTION_PROPORTION = 3
BID_PROPORTION = 46
TOTAL_PROPORTION = 50

FIRST_PERSON_ID = 1000
FIRST_AUCTION_ID = 1000
FIRST_CATEGORY_ID = 10

NUM_CATEGORIES = 5
HOT_AUCTION_RATIO = 100
HOT_BIDDER_RATIO = 100
HOT_SELLER_RATIO = 100
ACTIVE_PEOPLE = 1000
IN_FLIGHT_AUCTIONS = 100

#: synthetic start time (unix micros) — 2015-07-15, Beam's BASE_TIME
BASE_TIME_US = 1_436_918_400_000_000

_U64 = (1 << 64) - 1


def _signed(c: int) -> int:
    c &= _U64
    return c - (1 << 64) if c >= 1 << 63 else c


# ---------------------------------------------------------------------------
# counter-based randomness (int64 bit patterns of the reference's uint64)


def _umod(x: torch.Tensor, bound) -> torch.Tensor:
    """Unsigned ``x % bound`` of an int64 bit pattern, ``bound`` > 0."""
    return ((srl(x, 1) % bound) * 2 + (x & 1)) % bound


def _rand(event_id: torch.Tensor, stream: int) -> torch.Tensor:
    """uint64 uniform random (as int64 bits), keyed on (event id, stream)."""
    return mix64((event_id * K1) ^ _signed(stream * K3))


def _rand_int(event_id, stream: int, bound: int) -> torch.Tensor:
    return _umod(_rand(event_id, stream), bound)


def _rand_unit(event_id, stream: int) -> torch.Tensor:
    """float64 in [0, 1)."""
    return srl(_rand(event_id, stream), 11).to(torch.float64) / float(1 << 53)


def _last_base0_person_id(n: torch.Tensor) -> torch.Tensor:
    epoch = n // TOTAL_PROPORTION
    offset = torch.clamp(n % TOTAL_PROPORTION, max=PERSON_PROPORTION - 1)
    return epoch * PERSON_PROPORTION + offset


def _last_base0_auction_id(n: torch.Tensor) -> torch.Tensor:
    epoch = n // TOTAL_PROPORTION
    offset = n % TOTAL_PROPORTION
    before = offset < PERSON_PROPORTION
    epoch = torch.where(before, epoch - 1, epoch)
    offset = torch.where(
        before, torch.full_like(offset, AUCTION_PROPORTION - 1),
        torch.clamp(offset - PERSON_PROPORTION, max=AUCTION_PROPORTION - 1))
    return epoch * AUCTION_PROPORTION + offset


def _next_base0_person_id(eid: torch.Tensor, stream: int) -> torch.Tensor:
    # the reference chains ids from the event id (seed included)
    num_people = _last_base0_person_id(eid) + 1
    active = torch.clamp(num_people, max=ACTIVE_PEOPLE)
    return num_people - active + torch.minimum(
        _rand_int(eid, stream, ACTIVE_PEOPLE + 1), active)


def _next_base0_auction_id(eid: torch.Tensor, stream: int) -> torch.Tensor:
    max_auction = _last_base0_auction_id(eid)
    min_auction = torch.clamp(max_auction - IN_FLIGHT_AUCTIONS, min=0)
    span = max_auction - min_auction + 1
    return min_auction + _umod(_rand(eid, stream), span)


def _next_price(eid: torch.Tensor, stream: int) -> torch.Tensor:
    """Canonical nextPrice: round(10^(U*6) * 100) — long-tail prices."""
    u = _rand_unit(eid, stream)
    return torch.round(torch.pow(10.0, u * 6.0) * 100.0).to(torch.int64)


# ---------------------------------------------------------------------------
# schemas (same as the reference's)

BID_SCHEMA = Schema((
    Field("auction", DataType.INT64),
    Field("bidder", DataType.INT64),
    Field("price", DataType.INT64),
    Field("channel", DataType.VARCHAR, str_width=16),
    Field("url", DataType.VARCHAR, str_width=40),
    Field("date_time", DataType.TIMESTAMP),
))

AUCTION_SCHEMA = Schema((
    Field("id", DataType.INT64),
    Field("item_name", DataType.VARCHAR, str_width=24),
    Field("description", DataType.VARCHAR, str_width=32),
    Field("initial_bid", DataType.INT64),
    Field("reserve", DataType.INT64),
    Field("date_time", DataType.TIMESTAMP),
    Field("expires", DataType.TIMESTAMP),
    Field("seller", DataType.INT64),
    Field("category", DataType.INT64),
))

PERSON_SCHEMA = Schema((
    Field("id", DataType.INT64),
    Field("name", DataType.VARCHAR, str_width=24),
    Field("email_address", DataType.VARCHAR, str_width=32),
    Field("credit_card", DataType.VARCHAR, str_width=20),
    Field("city", DataType.VARCHAR, str_width=16),
    Field("state", DataType.VARCHAR, str_width=4),
    Field("date_time", DataType.TIMESTAMP),
))

SCHEMAS = {"bid": BID_SCHEMA, "auction": AUCTION_SCHEMA,
           "person": PERSON_SCHEMA}

_CHANNELS = ["Google", "Facebook", "Baidu", "Apple"]
_CITIES = ["Phoenix", "Los Angeles", "San Francisco", "Boise", "Portland",
           "Bend", "Redmond", "Seattle", "Kent", "Cheyenne"]
_STATES = ["AZ", "CA", "ID", "OR", "WA", "WY"]
_FIRST_NAMES = ["Peter", "Paul", "Luke", "John", "Saul", "Vicky", "Kate",
                "Julie", "Sarah", "Deiter", "Walter"]
_LAST_NAMES = ["Shultz", "Abrams", "Spencer", "White", "Bartels", "Walton",
               "Smith", "Jones", "Noris"]


class _BidArgs(ctypes.Structure):
    """Mirror of ``struct BidArgs`` in ``csrc/nexmark_bids.cu``."""

    _fields_ = [
        ("k0", ctypes.c_longlong), ("cap", ctypes.c_int),
        ("inter_event_us", ctypes.c_longlong),
        ("base_time_us", ctypes.c_longlong), ("seed", ctypes.c_longlong),
        ("channels", ctypes.c_void_p), ("channel_lens", ctypes.c_void_p),
        ("n_channels", ctypes.c_int), ("ch_w", ctypes.c_int),
        ("urls", ctypes.c_void_p), ("url_lens", ctypes.c_void_p),
        ("n_urls", ctypes.c_int), ("url_w", ctypes.c_int),
        ("auction", ctypes.c_void_p), ("bidder", ctypes.c_void_p),
        ("price", ctypes.c_void_p), ("channel", ctypes.c_void_p),
        ("channel_len", ctypes.c_void_p), ("url", ctypes.c_void_p),
        ("url_len", ctypes.c_void_p), ("date_time", ctypes.c_void_p),
        ("ops", ctypes.c_void_p), ("valid", ctypes.c_void_p),
    ]


class _AuctionArgs(ctypes.Structure):
    """Mirror of ``struct AuctionArgs`` in ``csrc/nexmark_events.cu``."""

    _fields_ = [
        ("k0", ctypes.c_longlong), ("cap", ctypes.c_int),
        ("inter_event_us", ctypes.c_longlong),
        ("base_time_us", ctypes.c_longlong), ("seed", ctypes.c_longlong),
        ("items", ctypes.c_void_p), ("item_lens", ctypes.c_void_p),
        ("n_items", ctypes.c_int), ("item_w", ctypes.c_int),
        ("descs", ctypes.c_void_p), ("desc_lens", ctypes.c_void_p),
        ("n_descs", ctypes.c_int), ("desc_w", ctypes.c_int),
        ("id", ctypes.c_void_p), ("item", ctypes.c_void_p),
        ("item_len", ctypes.c_void_p), ("desc", ctypes.c_void_p),
        ("desc_len", ctypes.c_void_p), ("initial_bid", ctypes.c_void_p),
        ("reserve", ctypes.c_void_p), ("date_time", ctypes.c_void_p),
        ("expires", ctypes.c_void_p), ("seller", ctypes.c_void_p),
        ("category", ctypes.c_void_p), ("ops", ctypes.c_void_p),
        ("valid", ctypes.c_void_p),
    ]


class _StrField(ctypes.Structure):
    """Mirror of ``struct StrField`` in ``csrc/nexmark_events.cu``."""

    _fields_ = [
        ("book", ctypes.c_void_p), ("lens", ctypes.c_void_p),
        ("n", ctypes.c_int), ("w", ctypes.c_int),
        ("out", ctypes.c_void_p), ("out_len", ctypes.c_void_p),
    ]


class _PersonArgs(ctypes.Structure):
    """Mirror of ``struct PersonArgs`` in ``csrc/nexmark_events.cu``."""

    _fields_ = [
        ("k0", ctypes.c_longlong), ("cap", ctypes.c_int),
        ("inter_event_us", ctypes.c_longlong),
        ("base_time_us", ctypes.c_longlong), ("seed", ctypes.c_longlong),
        ("name", _StrField), ("email", _StrField), ("card", _StrField),
        ("city", _StrField), ("state", _StrField),
        ("id", ctypes.c_void_p), ("date_time", ctypes.c_void_p),
        ("ops", ctypes.c_void_p), ("valid", ctypes.c_void_p),
    ]


@dataclass(frozen=True)
class NexmarkConfig:
    """Generator knobs."""

    #: microseconds between consecutive events (event time)
    inter_event_us: int = 10
    base_time_us: int = BASE_TIME_US
    seed: int = 0


class NexmarkGenerator:
    """Generator addressed by per-table ordinal ranges, on ``device``
    (the GPU unless the caller names another).

    ``gen_bids(k0, cap)`` returns the chunk of bids ``k0 .. k0+cap``;
    the k-th bid is global event ``(k // 46) * 50 + 4 + (k % 46)``."""

    def __init__(self, config: NexmarkConfig = NexmarkConfig(),
                 device=None):
        self.config = config
        self.device = resolve_device(device)
        book = self._codebook
        self._channels = book(_CHANNELS, 16)
        self._cities = book(_CITIES, 16)
        self._states = book(_STATES, 4)
        self._urls = book([f"https://nexmark.io/page{i}/item"
                           for i in range(32)], 40)
        self._names = book([f"{f} {l}" for f in _FIRST_NAMES
                            for l in _LAST_NAMES], 24)
        self._emails = book([f"{f.lower()}.{l.lower()}@nexmark.io"
                             for f in _FIRST_NAMES for l in _LAST_NAMES], 32)
        self._items = book([f"item-lot-{i:04d}" for i in range(64)], 24)
        self._descs = book([f"auction description {i}" for i in range(32)], 32)
        self._cards = book([f"{i:04d} {i+1:04d} {i+2:04d} {i+3:04d}"
                            for i in range(16)], 20)

    def _codebook(self, values: list[str], width: int) -> StrCol:
        data, lens = encode_strings(values, width)
        return StrCol(torch.from_numpy(data).to(self.device),
                      torch.from_numpy(lens).to(self.device))

    @staticmethod
    def _gather_str(book: StrCol, idx: torch.Tensor) -> StrCol:
        return StrCol(book.data[idx], book.lens[idx])

    def _timestamp(self, n: torch.Tensor) -> torch.Tensor:
        return self.config.base_time_us + n * self.config.inter_event_us

    def _event_id(self, n: torch.Tensor) -> torch.Tensor:
        # the seed folds into the randomness key, not the id chain
        return n + self.config.seed * (1 << 40)

    def _ordinals(self, k0: int, cap: int) -> torch.Tensor:
        return k0 + torch.arange(cap, dtype=torch.int64, device=self.device)

    def _chunk(self, cols, schema: Schema) -> Chunk:
        cap = cols[0].shape[0]
        return Chunk(cols,
                     torch.zeros(cap, dtype=torch.int8, device=self.device),
                     torch.ones(cap, dtype=torch.bool, device=self.device),
                     schema)

    def gen_bids(self, k0: int, cap: int) -> Chunk:
        """The chunk of bids ``k0 .. k0+cap``; on the card, kernel K9."""
        if self.device.type == "cuda":
            return self.gen_bids_cuda(k0, cap)
        return self.gen_bids_plain(k0, cap)

    def gen_bids_cuda(self, k0: int, cap: int) -> Chunk:
        """Kernel K9 (``csrc/nexmark_bids.cu``): one launch."""
        dev = self.device
        i64 = dict(dtype=torch.int64, device=dev)
        auction, bidder, price, date_time = (torch.empty(cap, **i64)
                                             for _ in range(4))
        ch, url = self._channels, self._urls
        channel = StrCol(torch.empty((cap, ch.data.shape[1]),
                                     dtype=torch.uint8, device=dev),
                         torch.empty(cap, dtype=torch.int32, device=dev))
        url_col = StrCol(torch.empty((cap, url.data.shape[1]),
                                     dtype=torch.uint8, device=dev),
                         torch.empty(cap, dtype=torch.int32, device=dev))
        ops = torch.empty(cap, dtype=torch.int8, device=dev)
        valid = torch.empty(cap, dtype=torch.bool, device=dev)
        kernels.require_cuda("nexmark_bids", ch.data, ch.lens, url.data,
                             url.lens, auction, channel.data, url_col.data,
                             ops, valid)
        a = _BidArgs()
        cfg = self.config
        a.k0, a.cap = k0, cap
        a.inter_event_us, a.base_time_us = cfg.inter_event_us, \
            cfg.base_time_us
        a.seed = cfg.seed
        a.channels, a.channel_lens = ch.data.data_ptr(), ch.lens.data_ptr()
        a.n_channels, a.ch_w = ch.data.shape
        a.urls, a.url_lens = url.data.data_ptr(), url.lens.data_ptr()
        a.n_urls, a.url_w = url.data.shape
        a.auction, a.bidder = auction.data_ptr(), bidder.data_ptr()
        a.price, a.date_time = price.data_ptr(), date_time.data_ptr()
        a.channel, a.channel_len = (channel.data.data_ptr(),
                                    channel.lens.data_ptr())
        a.url, a.url_len = url_col.data.data_ptr(), url_col.lens.data_ptr()
        a.ops, a.valid = ops.data_ptr(), valid.data_ptr()
        fn = kernels.entry("nexmark_bids", "rw_nexmark_bids",
                           [_BidArgs, ctypes.c_void_p])
        kernels.count_launch("nexmark_bids")
        kernels.check(fn(a, kernels.stream_ptr(dev)), "nexmark_bids")
        return Chunk((auction, bidder, price, channel, url_col, date_time),
                     ops, valid, BID_SCHEMA)

    def gen_bids_plain(self, k0: int, cap: int) -> Chunk:
        """Plain PyTorch version of kernel K9 (any device)."""
        k = self._ordinals(k0, cap)
        n = (k // BID_PROPORTION) * TOTAL_PROPORTION + PERSON_PROPORTION \
            + AUCTION_PROPORTION + (k % BID_PROPORTION)
        eid = self._event_id(n)
        hot = _rand_int(eid, 1, HOT_AUCTION_RATIO) > 0
        hot_auction = (_last_base0_auction_id(n) // HOT_AUCTION_RATIO) \
            * HOT_AUCTION_RATIO
        auction = torch.where(hot, hot_auction,
                              _next_base0_auction_id(eid, 2)) \
            + FIRST_AUCTION_ID
        hot_b = _rand_int(eid, 3, HOT_BIDDER_RATIO) > 0
        hot_bidder = (_last_base0_person_id(n) // HOT_BIDDER_RATIO) \
            * HOT_BIDDER_RATIO + 1
        bidder = torch.where(hot_b, hot_bidder,
                             _next_base0_person_id(eid, 4)) \
            + FIRST_PERSON_ID
        price = _next_price(eid, 5)
        channel = self._gather_str(self._channels,
                                   _rand_int(eid, 6, len(_CHANNELS)))
        url = self._gather_str(self._urls, _rand_int(eid, 7, 32))
        return self._chunk((auction, bidder, price, channel, url,
                            self._timestamp(n)), BID_SCHEMA)

    def gen_auctions(self, k0: int, cap: int,
                     cols: Sequence[int] | None = None) -> Chunk:
        """The chunk of auctions ``k0 .. k0+cap``, only the columns
        ``cols`` of ``AUCTION_SCHEMA`` (all when None), in that order; on
        the card, kernel K9's ``nexmark_auctions``."""
        if self.device.type == "cuda":
            return self.gen_auctions_cuda(k0, cap, cols)
        return self.gen_auctions_plain(k0, cap, cols)

    def gen_persons(self, k0: int, cap: int,
                    cols: Sequence[int] | None = None) -> Chunk:
        """The chunk of persons ``k0 .. k0+cap`` (columns ``cols`` of
        ``PERSON_SCHEMA``); on the card, kernel K9's ``nexmark_persons``."""
        if self.device.type == "cuda":
            return self.gen_persons_cuda(k0, cap, cols)
        return self.gen_persons_plain(k0, cap, cols)

    def _project(self, chunk: Chunk, cols) -> Chunk:
        if cols is None:
            return chunk
        return Chunk([chunk.columns[i] for i in cols], chunk.ops,
                     chunk.valid, chunk.schema.select(list(cols)))

    def gen_auctions_plain(self, k0: int, cap: int,
                           cols: Sequence[int] | None = None) -> Chunk:
        """Plain PyTorch version of K9's ``nexmark_auctions``."""
        k = self._ordinals(k0, cap)
        n = (k // AUCTION_PROPORTION) * TOTAL_PROPORTION \
            + PERSON_PROPORTION + (k % AUCTION_PROPORTION)
        eid = self._event_id(n)
        auction_id = _last_base0_auction_id(n) + FIRST_AUCTION_ID
        initial_bid = _next_price(eid, 10)
        reserve = initial_bid + _next_price(eid, 11)
        hot = _rand_int(eid, 12, HOT_SELLER_RATIO) > 0
        hot_seller = (_last_base0_person_id(n) // HOT_SELLER_RATIO) \
            * HOT_SELLER_RATIO
        seller = torch.where(hot, hot_seller,
                             _next_base0_person_id(eid, 13)) \
            + FIRST_PERSON_ID
        category = FIRST_CATEGORY_ID + _rand_int(eid, 14, NUM_CATEGORIES)
        ts = self._timestamp(n)
        expires = ts + (_rand_int(eid, 15, 4) + 1) \
            * self.config.inter_event_us * TOTAL_PROPORTION * 2
        item = self._gather_str(self._items, _rand_int(eid, 16, 64))
        desc = self._gather_str(self._descs, _rand_int(eid, 17, 32))
        return self._project(self._chunk(
            (auction_id, item, desc, initial_bid, reserve, ts, expires,
             seller, category), AUCTION_SCHEMA), cols)

    def gen_persons_plain(self, k0: int, cap: int,
                          cols: Sequence[int] | None = None) -> Chunk:
        """Plain PyTorch version of K9's ``nexmark_persons``."""
        k = self._ordinals(k0, cap)
        n = k * TOTAL_PROPORTION
        eid = self._event_id(n)
        person_id = _last_base0_person_id(n) + FIRST_PERSON_ID
        n_names = len(_FIRST_NAMES) * len(_LAST_NAMES)
        name = self._gather_str(self._names, _rand_int(eid, 20, n_names))
        email = self._gather_str(self._emails, _rand_int(eid, 21, n_names))
        card = self._gather_str(self._cards, _rand_int(eid, 22, 16))
        city = self._gather_str(self._cities,
                                _rand_int(eid, 23, len(_CITIES)))
        state = self._gather_str(self._states,
                                 _rand_int(eid, 24, len(_STATES)))
        return self._project(self._chunk(
            (person_id, name, email, card, city, state, self._timestamp(n)),
            PERSON_SCHEMA), cols)

    def _out_columns(self, schema: Schema, cols, cap: int):
        """Empty output columns for the kept ``cols`` (None elsewhere)."""
        dev = self.device
        keep = range(len(schema)) if cols is None else cols
        out: list = [None] * len(schema)
        for i in keep:
            f = schema[i]
            if f.data_type.is_string:
                out[i] = StrCol(torch.empty((cap, f.str_width),
                                            dtype=torch.uint8, device=dev),
                                torch.empty(cap, dtype=torch.int32,
                                            device=dev))
            else:
                out[i] = torch.empty(cap, dtype=torch.int64, device=dev)
        ops = torch.empty(cap, dtype=torch.int8, device=dev)
        valid = torch.empty(cap, dtype=torch.bool, device=dev)
        return out, ops, valid

    def _finish(self, schema, out, ops, valid, cols) -> Chunk:
        keep = list(range(len(schema))) if cols is None else list(cols)
        return Chunk([out[i] for i in keep], ops, valid,
                     schema.select(keep))

    def _fill_common(self, a, k0: int, cap: int) -> None:
        cfg = self.config
        a.k0, a.cap = k0, cap
        a.inter_event_us, a.base_time_us = cfg.inter_event_us, \
            cfg.base_time_us
        a.seed = cfg.seed

    def gen_auctions_cuda(self, k0: int, cap: int,
                          cols: Sequence[int] | None = None) -> Chunk:
        """K9 ``nexmark_auctions`` (``csrc/nexmark_events.cu``): one
        launch writing only the kept columns."""
        out, ops, valid = self._out_columns(AUCTION_SCHEMA, cols, cap)
        items, descs = self._items, self._descs
        kernels.require_cuda("nexmark_auctions", items.data, descs.data,
                             ops, valid)
        a = _AuctionArgs()
        self._fill_common(a, k0, cap)
        a.items, a.item_lens = items.data.data_ptr(), items.lens.data_ptr()
        a.n_items, a.item_w = items.data.shape
        a.descs, a.desc_lens = descs.data.data_ptr(), descs.lens.data_ptr()
        a.n_descs, a.desc_w = descs.data.shape

        def p(i):
            return None if out[i] is None else out[i].data_ptr()

        def ps(i):
            return (None, None) if out[i] is None else \
                (out[i].data.data_ptr(), out[i].lens.data_ptr())

        a.id, a.initial_bid, a.reserve = p(0), p(3), p(4)
        a.date_time, a.expires, a.seller, a.category = p(5), p(6), p(7), p(8)
        a.item, a.item_len = ps(1)
        a.desc, a.desc_len = ps(2)
        a.ops, a.valid = ops.data_ptr(), valid.data_ptr()
        fn = kernels.entry("nexmark_auctions", "rw_nexmark_auctions",
                           [_AuctionArgs, ctypes.c_void_p])
        kernels.count_launch("nexmark_auctions")
        kernels.check(fn(a, kernels.stream_ptr(self.device)),
                      "nexmark_auctions")
        return self._finish(AUCTION_SCHEMA, out, ops, valid, cols)

    def gen_persons_cuda(self, k0: int, cap: int,
                         cols: Sequence[int] | None = None) -> Chunk:
        """K9 ``nexmark_persons`` (``csrc/nexmark_events.cu``): one launch
        writing only the kept columns."""
        out, ops, valid = self._out_columns(PERSON_SCHEMA, cols, cap)
        kernels.require_cuda("nexmark_persons", self._names.data, ops, valid)
        a = _PersonArgs()
        self._fill_common(a, k0, cap)
        for fname, book, i in (("name", self._names, 1),
                               ("email", self._emails, 2),
                               ("card", self._cards, 3),
                               ("city", self._cities, 4),
                               ("state", self._states, 5)):
            f = getattr(a, fname)
            f.book, f.lens = book.data.data_ptr(), book.lens.data_ptr()
            f.n, f.w = book.data.shape
            if out[i] is not None:
                f.out, f.out_len = out[i].data.data_ptr(), \
                    out[i].lens.data_ptr()
        a.id = None if out[0] is None else out[0].data_ptr()
        a.date_time = None if out[6] is None else out[6].data_ptr()
        a.ops, a.valid = ops.data_ptr(), valid.data_ptr()
        fn = kernels.entry("nexmark_persons", "rw_nexmark_persons",
                           [_PersonArgs, ctypes.c_void_p])
        kernels.count_launch("nexmark_persons")
        kernels.check(fn(a, kernels.stream_ptr(self.device)),
                      "nexmark_persons")
        return self._finish(PERSON_SCHEMA, out, ops, valid, cols)


class NexmarkSplitReader:
    """A source split: a contiguous ordinal block per chunk of one table;
    the offset (event ordinal) is the checkpointable cursor."""

    def __init__(self, table: str, generator: NexmarkGenerator | None = None,
                 chunk_capacity: int = 4096, split_id: int = 0,
                 num_splits: int = 1, offset: int = 0):
        self.table = table
        self.gen = generator or NexmarkGenerator()
        self.cap = chunk_capacity
        self.split_id = split_id
        self.num_splits = num_splits
        self.offset = offset
        self._fn = {"bid": self.gen.gen_bids,
                    "auction": self.gen.gen_auctions,
                    "person": self.gen.gen_persons}[table]

    @property
    def events_per_row(self) -> Fraction:
        return {"bid": Fraction(TOTAL_PROPORTION, BID_PROPORTION),
                "auction": Fraction(TOTAL_PROPORTION, AUCTION_PROPORTION),
                "person": Fraction(TOTAL_PROPORTION, PERSON_PROPORTION),
                }[self.table]

    def next_base(self) -> int:
        """Advance the cursor; the global ordinal of the next block."""
        base = (self.offset // self.cap) * self.cap * self.num_splits \
            + self.split_id * self.cap + (self.offset % self.cap)
        self.offset += self.cap
        return base

    def next_chunk(self, cols: Sequence[int] | None = None) -> Chunk:
        """The next chunk; ``cols`` keeps only those columns (auctions and
        persons generate only them; bids are projected after)."""
        return self.impl(self.next_base(), self.cap, cols)

    def impl(self, k0: int, cap: int,
             cols: Sequence[int] | None = None) -> Chunk:
        """The block of ``cap`` events from global ordinal ``k0`` (the
        reference's ``impl``: a sharded job generates each lane's block
        from its own ``next_base``)."""
        if self.table == "bid":
            chunk = self._fn(k0, cap)
            if cols is None:
                return chunk
            return Chunk([chunk.columns[i] for i in cols], chunk.ops,
                         chunk.valid, chunk.schema.select(list(cols)))
        return self._fn(k0, cap, cols)

    def state(self) -> dict:
        return {"table": self.table, "split_id": self.split_id,
                "offset": self.offset}
