"""Column schema for MLTable (paper §III-A).

Counterpart: ``src/repro/core/schema.py``, of which this is the port's own
copy (the reference module is numpy-free Python; the port imports nothing
of the reference package).  Columns are typed String / Integer / Boolean /
Scalar; any cell may be ``Empty`` (represented by a singleton sentinel).
The schema governs which relational / numeric operations are legal and how
a table is committed to the device tier (``MLNumericTable``).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Iterable, Optional, Sequence, Tuple

__all__ = [
    "ColumnType",
    "Column",
    "Schema",
    "MLRow",
    "EMPTY",
]


class _Empty:
    """Singleton sentinel for the paper's 'Empty' cell value."""

    _instance: Optional["_Empty"] = None

    def __new__(cls) -> "_Empty":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:  # pragma: no cover - trivial
        return "Empty"

    def __bool__(self) -> bool:
        return False


EMPTY = _Empty()


class ColumnType(enum.Enum):
    STRING = "string"
    INTEGER = "integer"
    BOOLEAN = "boolean"
    SCALAR = "scalar"

    @classmethod
    def infer(cls, value: Any) -> "ColumnType":
        if isinstance(value, bool):
            return cls.BOOLEAN
        if isinstance(value, int):
            return cls.INTEGER
        if isinstance(value, float):
            return cls.SCALAR
        if isinstance(value, str):
            return cls.STRING
        raise TypeError(f"cannot infer MLTable column type for {value!r}")

    @property
    def is_numeric(self) -> bool:
        return self in (ColumnType.INTEGER, ColumnType.SCALAR, ColumnType.BOOLEAN)


@dataclasses.dataclass(frozen=True)
class Column:
    ctype: ColumnType
    name: Optional[str] = None

    def validate(self, value: Any) -> None:
        if value is EMPTY:
            return
        expected = ColumnType.infer(value)
        ok = expected is self.ctype or (
            # ints are acceptable in scalar columns
            self.ctype is ColumnType.SCALAR
            and expected is ColumnType.INTEGER
        )
        if not ok:
            raise TypeError(
                f"value {value!r} of type {expected} does not conform to column "
                f"{self.name or '<anon>'}:{self.ctype}"
            )


@dataclasses.dataclass(frozen=True)
class Schema:
    columns: Tuple[Column, ...]

    @classmethod
    def of(cls, *ctypes: ColumnType, names: Optional[Sequence[str]] = None) -> "Schema":
        if names is None:
            names = [None] * len(ctypes)  # type: ignore[list-item]
        if len(names) != len(ctypes):
            raise ValueError("names/ctypes length mismatch")
        return cls(tuple(Column(t, n) for t, n in zip(ctypes, names)))

    @classmethod
    def infer_from_row(cls, row: Sequence[Any], names: Optional[Sequence[str]] = None) -> "Schema":
        ctypes = [ColumnType.infer(v) if v is not EMPTY else ColumnType.SCALAR for v in row]
        return cls.of(*ctypes, names=names)

    def __len__(self) -> int:
        return len(self.columns)

    @property
    def names(self) -> Tuple[Optional[str], ...]:
        return tuple(c.name for c in self.columns)

    @property
    def is_numeric(self) -> bool:
        return all(c.ctype.is_numeric for c in self.columns)

    def index_of(self, name: str) -> int:
        for i, c in enumerate(self.columns):
            if c.name == name:
                return i
        raise KeyError(f"no column named {name!r}")

    def project(self, indices: Sequence[int]) -> "Schema":
        return Schema(tuple(self.columns[i] for i in indices))

    def validate_row(self, row: Sequence[Any]) -> None:
        if len(row) != len(self.columns):
            raise ValueError(
                f"row arity {len(row)} does not match schema arity {len(self.columns)}"
            )
        for col, v in zip(self.columns, row):
            col.validate(v)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Schema):
            return NotImplemented
        return tuple(c.ctype for c in self.columns) == tuple(c.ctype for c in other.columns)

    def __hash__(self) -> int:
        return hash(tuple(c.ctype for c in self.columns))


class MLRow(tuple):
    """A single table row.  Immutable; cells accessed by index or column name.

    The paper's MLRow supports positional access and conversion to feature
    vectors; we attach the schema for name-based access.
    """

    schema: Optional[Schema]

    def __new__(cls, values: Iterable[Any], schema: Optional[Schema] = None) -> "MLRow":
        obj = super().__new__(cls, tuple(values))
        obj.schema = schema
        return obj

    def get(self, key: Any) -> Any:
        if isinstance(key, str):
            if self.schema is None:
                raise KeyError("row has no schema; name-based access unavailable")
            return self[self.schema.index_of(key)]
        return self[key]

    def is_empty(self, i: int) -> bool:
        return self[i] is EMPTY

    def to_floats(self) -> Tuple[float, ...]:
        out = []
        for v in self:
            if v is EMPTY:
                out.append(float("nan"))
            elif isinstance(v, bool):
                out.append(1.0 if v else 0.0)
            elif isinstance(v, (int, float)):
                out.append(float(v))
            else:
                raise TypeError(f"non-numeric cell {v!r} cannot be converted to float")
        return tuple(out)
