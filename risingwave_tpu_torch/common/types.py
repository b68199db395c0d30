"""Logical data types and schemas.

Port of ``risingwave_tpu/common/types.py``.  Every logical type maps to
a fixed-width physical torch dtype, so a chunk is a set of fixed-shape
tensors:

- integers/floats/bool map 1:1 onto torch dtypes;
- ``DECIMAL`` is a scaled ``int64`` (value * 10^scale);
- temporal types are integer epochs (TIMESTAMP is int64 microseconds,
  DATE int32 days);
- ``VARCHAR`` is a ``[cap, width]`` uint8 tensor plus int32 lengths.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import torch


class DataType(enum.Enum):
    """Logical column types (same members and SQL names as the
    reference package)."""

    BOOLEAN = "boolean"
    INT16 = "smallint"
    INT32 = "int"
    INT64 = "bigint"
    FLOAT32 = "real"
    FLOAT64 = "double precision"
    DECIMAL = "numeric"          # scaled int64, scale fixed per column
    DATE = "date"                # i32 days since unix epoch
    TIME = "time"                # i64 microseconds since midnight
    TIMESTAMP = "timestamp"      # i64 microseconds since unix epoch (naive)
    TIMESTAMPTZ = "timestamptz"  # i64 microseconds since unix epoch (UTC)
    INTERVAL = "interval"        # i64 microseconds
    VARCHAR = "character varying"
    BYTEA = "bytea"
    SERIAL = "serial"            # i64 row-id

    @property
    def physical_dtype(self) -> torch.dtype:
        """The torch dtype of the device column (bytes for strings)."""
        return _PHYSICAL[self]

    @property
    def is_string(self) -> bool:
        return self in (DataType.VARCHAR, DataType.BYTEA)

    @property
    def is_integral(self) -> bool:
        return self in (
            DataType.INT16, DataType.INT32, DataType.INT64, DataType.SERIAL,
            DataType.DATE, DataType.TIME, DataType.TIMESTAMP,
            DataType.TIMESTAMPTZ, DataType.INTERVAL, DataType.DECIMAL,
        )

    @classmethod
    def from_sql(cls, name: str) -> "DataType":
        return parse_sql_type(name)[0]


_PHYSICAL: dict[DataType, torch.dtype] = {
    DataType.BOOLEAN: torch.bool,
    DataType.INT16: torch.int16,
    DataType.INT32: torch.int32,
    DataType.INT64: torch.int64,
    DataType.FLOAT32: torch.float32,
    DataType.FLOAT64: torch.float64,
    DataType.DECIMAL: torch.int64,
    DataType.DATE: torch.int32,
    DataType.TIME: torch.int64,
    DataType.TIMESTAMP: torch.int64,
    DataType.TIMESTAMPTZ: torch.int64,
    DataType.INTERVAL: torch.int64,
    DataType.VARCHAR: torch.uint8,
    DataType.BYTEA: torch.uint8,
    DataType.SERIAL: torch.int64,
}

#: numpy dtype names of the physical types (host conversion)
NUMPY_DTYPE = {
    torch.bool: "bool", torch.int16: "int16", torch.int32: "int32",
    torch.int64: "int64", torch.float32: "float32",
    torch.float64: "float64", torch.uint8: "uint8", torch.int8: "int8",
}

_SQL_NAMES: dict[str, DataType] = {t.value: t for t in DataType}
_SQL_NAMES.update(
    {
        "bool": DataType.BOOLEAN,
        "int2": DataType.INT16,
        "smallint": DataType.INT16,
        "int4": DataType.INT32,
        "integer": DataType.INT32,
        "int8": DataType.INT64,
        "bigint": DataType.INT64,
        "float4": DataType.FLOAT32,
        "real": DataType.FLOAT32,
        "float8": DataType.FLOAT64,
        "double": DataType.FLOAT64,
        "decimal": DataType.DECIMAL,
        "varchar": DataType.VARCHAR,
        "string": DataType.VARCHAR,
        "text": DataType.VARCHAR,
        "char": DataType.VARCHAR,
        "character": DataType.VARCHAR,
        "timestamp without time zone": DataType.TIMESTAMP,
        "timestamp with time zone": DataType.TIMESTAMPTZ,
    }
)


def parse_sql_type(name: str):
    """``(DataType, declared-width-or-None, declared-scale-or-None)``."""
    s = name.strip().lower()
    width = scale = None
    if "(" in s:
        base, _, rest = s.partition("(")
        args = rest.rstrip(") ").split(",")
        t = _SQL_NAMES[base.strip()]
        if t.is_string:
            width = int(args[0])
        elif t == DataType.DECIMAL and len(args) > 1:
            scale = int(args[1])
        return t, width, scale
    return _SQL_NAMES[s], None, None


#: default device width (bytes) of a VARCHAR column
DEFAULT_STR_WIDTH = 64
#: default decimal scale (micro-units)
DEFAULT_DECIMAL_SCALE = 6


@dataclass(frozen=True)
class Field:
    """A named, typed column."""

    name: str
    data_type: DataType
    str_width: int = DEFAULT_STR_WIDTH
    decimal_scale: int = DEFAULT_DECIMAL_SCALE
    nullable: bool = False

    def with_nullable(self, nullable: bool = True) -> "Field":
        from dataclasses import replace
        return replace(self, nullable=nullable)

    def __repr__(self) -> str:
        mark = "?" if self.nullable else ""
        return f"{self.name}:{self.data_type.name.lower()}{mark}"


@dataclass(frozen=True)
class Schema:
    """An ordered list of fields."""

    fields: tuple[Field, ...] = field(default_factory=tuple)

    def __post_init__(self) -> None:
        object.__setattr__(self, "fields", tuple(self.fields))

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __getitem__(self, i: int) -> Field:
        return self.fields[i]

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)

    def names(self) -> list[str]:
        return [f.name for f in self.fields]

    def data_types(self) -> list[DataType]:
        return [f.data_type for f in self.fields]

    def select(self, indices: list[int]) -> "Schema":
        return Schema(tuple(self.fields[i] for i in indices))

    def concat(self, other: "Schema") -> "Schema":
        return Schema(self.fields + other.fields)

    @staticmethod
    def of(*cols: tuple[str, DataType]) -> "Schema":
        return Schema(tuple(Field(n, t) for n, t in cols))
