"""Typed arrays and compute kernels for the SQL engine, without Arrow.

The JAX engine evaluates SQL on ``pyarrow`` arrays with ``pyarrow.compute``
kernels. The port has no ``pyarrow``, so the engine runs on ``Arr``: one
column as a numpy ``data`` array, an optional ``valid`` mask (None when no
row is null) and its Arrow type as ``batch.py`` spells types. Numeric and
bool columns keep numpy dtypes; string, binary, null and nested columns hold
Python objects (a null slot holds ``""``, ``b""`` or ``None``).

Every kernel here copies the ``pyarrow.compute`` semantics the JAX engine
relies on, where they differ from Python's or numpy's:

- integer ``+ - *`` wrap on overflow; integer ``/`` truncates toward zero
  and raises ``divide by zero`` on a zero divisor (``INT64_MIN / -1`` is 0);
- numeric promotion follows Arrow's common numeric type (int32 with uint8 is
  int32, int8 with uint8 is int16, any integer with float32 is float32);
- a float cast to string writes Arrow's shortest form (``1.0`` as ``1``,
  ``1e20`` as ``1e+20``, ``1e-7`` as ``1e-7``, NaN as ``nan``); an unsafe
  cast from float to int truncates; a string parses strictly; an implicit
  cast (numeric promotion, the common type of ``if_else``, ``is_in``) is
  safe: an integer past what the float type holds exactly raises;
- ``round`` rounds half to even on the scaled value, as ``pc.round`` does;
- AND and OR are Kleene; ``if_else`` with a null condition is null;
- ``is_in`` matches a null to a null in the set and never returns null;
- sorting is stable, NaN after every number and nulls last, either way.

Errors Arrow raises on bad input (a type with no kernel, a failed parse)
raise ``ComputeError`` with Arrow's message.
"""

from __future__ import annotations

import math
import re
from typing import Any, Optional, Sequence

import numpy as np

from arkflow_tpu_torch.batch import (BinaryColumn, Column, ObjectColumn, StringColumn,
                                     VarlenColumn, column_type, convert_value, infer_type,
                                     type_name)
from arkflow_tpu_torch.errors import ArkError

INTS = ("int8", "int16", "int32", "int64")
UINTS = ("uint8", "uint16", "uint32", "uint64")
FLOATS = ("halffloat", "float", "double")
#: the numpy dtype of each type an ``Arr`` keeps in a numpy array
NUMPY_DTYPE = {"bool": np.bool_, **{t: np.dtype(t) for t in INTS + UINTS},
               "halffloat": np.float16, "float": np.float32, "double": np.float64}
_EMPTY = {"string": "", "binary": b""}


class ComputeError(ArkError):
    """A kernel refused its input, where ``pyarrow.compute`` raises
    (``ArrowInvalid``, ``ArrowNotImplementedError``, ``ArrowTypeError``)."""


def is_integer(t) -> bool:
    return t in INTS or t in UINTS


def is_floating(t) -> bool:
    return t in FLOATS


def is_numeric(t) -> bool:
    return is_integer(t) or is_floating(t)


def is_varlen(t) -> bool:
    return t in ("string", "binary")


class Arr:
    """One typed column: ``data`` (numpy, object dtype for non-numeric
    types), ``valid`` (bool mask or None) and the Arrow ``type``."""

    __slots__ = ("type", "data", "valid")

    def __init__(self, type_, data: np.ndarray, valid: Optional[np.ndarray] = None):
        self.type = type_
        self.data = data
        self.valid = None if valid is None or valid.all() else valid

    def __len__(self) -> int:
        return len(self.data)

    def mask(self) -> np.ndarray:
        """The validity of every row (True where not null)."""
        if self.type == "null":
            return np.zeros(len(self.data), bool)
        return np.ones(len(self.data), bool) if self.valid is None else self.valid

    def to_pylist(self) -> list:
        if self.type == "null":
            return [None] * len(self.data)
        vals = self.data.tolist()
        if self.valid is None:
            return vals
        return [v if ok else None for v, ok in zip(vals, self.valid)]

    def take(self, idx: np.ndarray) -> "Arr":
        return Arr(self.type, self.data[idx], None if self.valid is None else self.valid[idx])


def objects(values: Sequence[Any]) -> np.ndarray:
    out = np.empty(len(values), object)
    out[:] = values
    return out


def from_pylist(values: Sequence[Any], type_=None) -> Arr:
    """An ``Arr`` from Python values, of ``type_`` or the type
    ``pyarrow.array`` infers (``batch.infer_type``)."""
    t = infer_type(values) if type_ is None else type_
    vals = [convert_value(v, t) for v in values]
    valid = np.fromiter((v is not None for v in vals), bool, count=len(vals))
    if t in NUMPY_DTYPE:
        data = np.array([0 if v is None else v for v in vals], dtype=NUMPY_DTYPE[t])
    elif t == "null":
        data = objects([None] * len(vals))
    elif t in _EMPTY:
        data = objects([_EMPTY[t] if v is None else v for v in vals])
    else:
        data = objects(vals)
    return Arr(t, data, valid)


def from_column(col: Column) -> Arr:
    """A port column (``batch.py``) as an ``Arr``."""
    if isinstance(col, np.ndarray):
        if col.ndim > 1:
            return Arr(column_type(col), objects(col.tolist()))
        if col.dtype.kind in "UO":  # a string column of the metadata kind
            vals = col.tolist()
            valid = np.fromiter((v is not None for v in vals), bool, count=len(vals))
            return Arr("string", objects(["" if v is None else str(v) for v in vals]), valid)
        return Arr(column_type(col), col)
    if isinstance(col, VarlenColumn):
        vals = col.to_bytes()
        if col.TYPE == "string":
            vals = [v.decode("utf-8") for v in vals]
        return Arr(col.TYPE, objects(vals), col.valid)
    return from_pylist(col.values, col.type)


def to_column(a: Arr) -> Column:
    """An ``Arr`` as a port column: numpy where no row is null, a string
    or binary column, else an ``ObjectColumn``."""
    t = a.type
    if t in NUMPY_DTYPE and a.valid is None:
        return np.asarray(a.data, dtype=NUMPY_DTYPE[t])
    if t == "string":
        return StringColumn.from_pylist(a.to_pylist())
    if t == "binary":
        return BinaryColumn.from_pylist(a.to_pylist())
    if (isinstance(t, tuple) and t[0] == "fixed_size_list" and a.valid is None
            and t[1] in NUMPY_DTYPE):
        return np.array(a.data.tolist(), dtype=NUMPY_DTYPE[t[1]]).reshape(len(a), t[2])
    return ObjectColumn(a.to_pylist(), t)


def scalar_type(v: Any):
    """The type ``pa.scalar(v)`` gives a Python value."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "bool"
    if isinstance(v, int):
        if -2 ** 63 <= v < 2 ** 63:
            return "int64"
        if 0 <= v < 2 ** 64:
            return "uint64"
        raise ComputeError(f"int too big to convert: {v}")
    if isinstance(v, float):
        return "double"
    return infer_type([v])


def broadcast(v: Any, n: int, type_=None) -> Arr:
    """A Python scalar repeated ``n`` times (``pa.repeat(pa.scalar(v), n)``);
    None is the null type."""
    t = scalar_type(v) if type_ is None else type_
    if v is None or t == "null":
        if t in NUMPY_DTYPE:
            return Arr(t, np.zeros(n, NUMPY_DTYPE[t]), np.zeros(n, bool))
        return Arr(t, objects([_EMPTY.get(t)] * n), np.zeros(n, bool))
    if t in NUMPY_DTYPE:
        return Arr(t, np.full(n, v, dtype=NUMPY_DTYPE[t]))
    return Arr(t, objects([convert_value(v, t)] * n))


def nulls(n: int, type_="null") -> Arr:
    return broadcast(None, n, type_)


# -- common types and casts ----------------------------------------------------


def _bits(t: str) -> int:
    return int(re.sub(r"\D", "", t))


def common_numeric(a, b):
    """Arrow's common numeric type of two numeric types, or None."""
    if not (is_numeric(a) and is_numeric(b)):
        return None
    if a == b:
        return a
    if is_floating(a) or is_floating(b):
        return "double" if "double" in (a, b) else "float"
    if (a in UINTS) == (b in UINTS):
        w = max(_bits(a), _bits(b))
        return f"{'u' if a in UINTS else ''}int{w}"
    s, u = (a, b) if a in INTS else (b, a)
    return f"int{min(64, max(_bits(s), 2 * _bits(u)))}"


def common_type(a, b):
    """The type two branches of ``if_else`` or ``coalesce`` meet in."""
    if a == b:
        return a
    if a == "null":
        return b
    if b == "null":
        return a
    t = common_numeric(a, b)
    if t is None:
        raise ComputeError(f"no common type for {type_name(a)} and {type_name(b)}")
    return t


_FLOAT_RE = re.compile(r"[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|inf|infinity|nan)",
                       re.IGNORECASE)
_INT_RE = re.compile(r"-?\d+")


def _parse(s: str, t) -> Any:
    if is_floating(t):
        if _FLOAT_RE.fullmatch(s):
            return float(s)
    elif t in INTS or t in UINTS:
        if _INT_RE.fullmatch(s):
            v = int(s)
            lo, hi = ((0, 2 ** _bits(t) - 1) if t in UINTS
                      else (-2 ** (_bits(t) - 1), 2 ** (_bits(t) - 1) - 1))
            if lo <= v <= hi:
                return v
    elif t == "bool":
        low = s.lower()
        if low in ("true", "1"):
            return True
        if low in ("false", "0"):
            return False
        raise ComputeError(f"Failed to parse value: {s}")
    raise ComputeError(f"Failed to parse string: '{s}' as a scalar of type {type_name(t)}")


def float_to_str(x: float, single: bool = False) -> str:
    """Arrow's text of a float: the shortest round-trip digits, decimal
    notation for exponents -6..9 and ``d.ddde+N`` beyond, no trailing
    ``.0``, and ``nan``, ``inf``, ``-inf``."""
    if math.isnan(x):
        return "nan"
    if math.isinf(x):
        return "inf" if x > 0 else "-inf"
    sci = np.format_float_scientific(np.float32(x) if single else np.float64(x),
                                     unique=True, trim="-")
    mant, exp = sci.split("e")
    sign = "-" if mant.startswith("-") else ""
    digits = mant.lstrip("-").replace(".", "")
    e = int(exp)
    if digits.strip("0") == "":
        return sign + "0"
    if -6 <= e < 10:
        point = e + 1
        if point <= 0:
            return f"{sign}0.{'0' * -point}{digits}"
        if point >= len(digits):
            return sign + digits + "0" * (point - len(digits))
        return f"{sign}{digits[:point]}.{digits[point:]}"
    head = digits[0] + ("." + digits[1:] if len(digits) > 1 else "")
    return f"{sign}{head}e{'+' if e >= 0 else '-'}{abs(e)}"


def _to_text(v: Any, t) -> str:
    if t == "bool":
        return "true" if v else "false"
    if is_floating(t):
        return float_to_str(float(v), single=(t != "double"))
    if t == "binary":
        return v.decode("utf-8")
    return str(v)


def cast(a: Arr, t) -> Arr:
    """``pc.cast(a, t, safe=False)``."""
    src = a.type
    if src == t:
        return a
    n = len(a)
    if src == "null":
        return nulls(n, t)
    ok = a.mask()
    if t in NUMPY_DTYPE and (src in NUMPY_DTYPE):
        with np.errstate(all="ignore"):
            if t == "bool":
                data = a.data != 0
            else:
                data = a.data.astype(NUMPY_DTYPE[t])
        return Arr(t, data, a.valid)
    if t in NUMPY_DTYPE and is_varlen(src):
        vals = [_parse(v if src == "string" else v.decode("utf-8"), t) if k else 0
                for v, k in zip(a.data.tolist(), ok)]
        return Arr(t, np.array(vals, dtype=NUMPY_DTYPE[t]), a.valid)
    if t == "string" and (src in NUMPY_DTYPE or src == "binary"):
        vals = [_to_text(v, src) if k else "" for v, k in zip(a.data.tolist(), ok)]
        return Arr(t, objects(vals), a.valid)
    if t == "binary" and src == "string":
        return Arr(t, objects([v.encode("utf-8") for v in a.data.tolist()]), a.valid)
    raise ComputeError(f"Unsupported cast from {type_name(src)} to {type_name(t)}")


#: integers a float type holds exactly (Arrow's implicit casts check them)
_EXACT_INT = {"halffloat": 2 ** 11, "float": 2 ** 24, "double": 2 ** 53}


def numeric_data(a: Arr, t) -> np.ndarray:
    """``a``'s values in type ``t`` as Arrow's implicit (safe) cast gives
    them: an integer past the range a float type holds exactly raises."""
    if is_integer(a.type) and is_floating(t) and _bits(a.type) > _mantissa_bits(t):
        lim = _EXACT_INT[t]
        live = a.data if a.valid is None else a.data[a.valid]
        bad = live[(live > lim) | (live < -lim)] if len(live) else live
        if len(bad):
            raise ComputeError(f"Integer value {int(bad[0])} not in range: -{lim} to {lim}")
    with np.errstate(all="ignore"):
        return a.data.astype(NUMPY_DTYPE[t], copy=False)


def _mantissa_bits(t) -> int:
    return {"halffloat": 11, "float": 24, "double": 53}[t]


def promote(a: Arr, t) -> Arr:
    """``a`` in the common type ``t`` by Arrow's implicit cast."""
    if a.type == t:
        return a
    if a.type == "null":
        return nulls(len(a), t)
    if a.type in NUMPY_DTYPE and t in NUMPY_DTYPE and t != "bool":
        return Arr(t, numeric_data(a, t), a.valid)
    return cast(a, t)


def cast_checked(a: Arr, t) -> Arr:
    """``pc.cast(a, t)`` with ``safe=True`` from float to integer: a NaN,
    an infinity or a fraction raises, as Arrow's truncation check does."""
    if is_floating(a.type) and is_integer(t):
        live = a.data if a.valid is None else a.data[a.valid]
        info = np.iinfo(NUMPY_DTYPE[t])
        with np.errstate(all="ignore"):
            bad = (live[~np.isfinite(live) | (np.floor(live) != live) | (live < info.min)
                        | (live >= float(info.max) + 1)] if len(live) else live)
        if len(bad):
            raise ComputeError(f"Float value {float(bad[0])} was truncated converting to "
                               f"{type_name(t)}")
    return cast(a, t)


def both_valid(a: Arr, b: Arr) -> Optional[np.ndarray]:
    if a.type == "null" or b.type == "null":
        return np.zeros(len(a), bool)
    if a.valid is None:
        return b.valid
    if b.valid is None:
        return a.valid
    return a.valid & b.valid


# -- arithmetic and comparison ------------------------------------------------


def arith(op: str, a: Arr, b: Arr) -> Arr:
    """``pc.add``, ``subtract``, ``multiply``, ``divide`` (unchecked)."""
    n = len(a)
    if a.type == "null" or b.type == "null":
        other = b.type if a.type == "null" else a.type
        t = other if other != "null" and is_numeric(other) else "null"
        return nulls(n, t)
    t = common_numeric(a.type, b.type)
    if t is None:
        raise ComputeError(f"Function '{_ARITH_NAMES[op]}' has no kernel matching input "
                           f"types ({type_name(a.type)}, {type_name(b.type)})")
    x, y = numeric_data(a, t), numeric_data(b, t)
    valid = both_valid(a, b)
    with np.errstate(all="ignore"):
        if op == "+":
            out = x + y
        elif op == "-":
            out = x - y
        elif op == "*":
            out = x * y
        elif is_floating(t):
            out = x / y
        else:
            live = np.ones(n, bool) if valid is None else valid
            if (y[live] == 0).any():
                raise ComputeError("divide by zero")
            safe = np.where(y == 0, 1, y).astype(y.dtype)
            q = x // safe
            q = q + (((x % safe) != 0) & ((x < 0) != (safe < 0))).astype(q.dtype)
            if t in INTS:
                lo = np.iinfo(NUMPY_DTYPE[t]).min
                q = np.where((x == lo) & (safe == -1), 0, q).astype(q.dtype)
            out = q
    return Arr(t, out.astype(NUMPY_DTYPE[t], copy=False), valid)


_ARITH_NAMES = {"+": "add", "-": "subtract", "*": "multiply", "/": "divide"}
_CMP_NAMES = {"=": "equal", "!=": "not_equal", "<": "less", "<=": "less_equal",
              ">": "greater", ">=": "greater_equal"}


def _cmp_values(op: str, x, y):
    if op == "=":
        return x == y
    if op == "!=":
        return x != y
    if op == "<":
        return x < y
    if op == "<=":
        return x <= y
    if op == ">":
        return x > y
    return x >= y


def compare(op: str, a: Arr, b: Arr) -> Arr:
    """``pc.equal`` and the other comparisons: null where either is null."""
    n = len(a)
    if a.type == "null" or b.type == "null":
        return nulls(n, "bool")
    valid = both_valid(a, b)
    t = common_numeric(a.type, b.type)
    if t is not None:
        with np.errstate(all="ignore"):
            return Arr("bool", np.asarray(_cmp_values(op, numeric_data(a, t),
                                                      numeric_data(b, t)), bool), valid)
    if a.type == b.type and (a.type == "bool" or is_varlen(a.type)):
        if a.type == "bool":
            out = _cmp_values(op, a.data, b.data)
        else:
            out = np.fromiter((_cmp_values(op, x, y) for x, y in zip(a.data, b.data)),
                              bool, count=n)
        return Arr("bool", np.asarray(out, bool), valid)
    raise ComputeError(f"Function '{_CMP_NAMES[op]}' has no kernel matching input types "
                       f"({type_name(a.type)}, {type_name(b.type)})")


def to_bool(a: Arr) -> Arr:
    return a if a.type == "bool" else cast(a, "bool")


def and_kleene(a: Arr, b: Arr) -> Arr:
    a, b = to_bool(a), to_bool(b)
    va, vb = a.mask(), b.mask()
    x = a.data.astype(bool) & va
    y = b.data.astype(bool) & vb
    false_a, false_b = va & ~a.data.astype(bool), vb & ~b.data.astype(bool)
    return Arr("bool", x & y, (va & vb) | false_a | false_b)


def or_kleene(a: Arr, b: Arr) -> Arr:
    a, b = to_bool(a), to_bool(b)
    va, vb = a.mask(), b.mask()
    x = a.data.astype(bool) & va
    y = b.data.astype(bool) & vb
    return Arr("bool", x | y, (va & vb) | x | y)


def invert(a: Arr) -> Arr:
    if a.type == "null":
        return nulls(len(a), "bool")
    if a.type != "bool":
        raise ComputeError(f"Function 'invert' has no kernel matching input types "
                           f"({type_name(a.type)})")
    return Arr("bool", ~a.data.astype(bool), a.valid)


def negate(a: Arr) -> Arr:
    if not is_numeric(a.type):
        if a.type == "null":
            return a
        raise ComputeError(f"Function 'negate' has no kernel matching input types "
                           f"({type_name(a.type)})")
    with np.errstate(all="ignore"):
        return Arr(a.type, np.negative(a.data), a.valid)


def is_null(a: Arr) -> Arr:
    return Arr("bool", ~a.mask())


def is_valid(a: Arr) -> Arr:
    return Arr("bool", a.mask().copy())


def if_else(cond: Arr, x: Arr, y: Arr) -> Arr:
    """``pc.if_else``: ``x`` where ``cond`` is true, ``y`` where false, null
    where ``cond`` is null; the branches meet in their common type."""
    cond = to_bool(cond) if cond.type != "null" else Arr("bool", np.zeros(len(cond), bool),
                                                         np.zeros(len(cond), bool))
    t = common_type(x.type, y.type)
    x, y = promote(x, t), promote(y, t)
    c = cond.data.astype(bool)
    if t in NUMPY_DTYPE:
        data = np.where(c, x.data, y.data).astype(NUMPY_DTYPE[t], copy=False)
    else:
        data = objects([a if k else b for a, b, k in zip(x.data, y.data, c)])
    valid = cond.mask() & np.where(c, x.mask(), y.mask())
    return Arr(t, data, valid)


def is_in(a: Arr, items: Sequence[Any]) -> Arr:
    """``pc.is_in(a, value_set=pa.array(items))``: a null row is true when
    the set holds a null; the result has no nulls."""
    set_type = infer_type(items) if any(i is not None for i in items) else a.type
    has_null = any(i is None for i in items)
    vals = [i for i in items if i is not None]
    n = len(a)
    ok = a.mask()
    if a.type == "null":
        return Arr("bool", np.full(n, has_null))
    if not (a.type == set_type or common_numeric(a.type, set_type) is not None
            or set_type == "null"):
        raise ComputeError(f"Array type doesn't match type of values set: "
                           f"{type_name(a.type)} vs {type_name(set_type)}")
    if is_numeric(a.type):
        floating = is_floating(a.type) or any(isinstance(v, float) for v in vals)
        dt = np.float64 if floating else np.int64
        x = numeric_data(a, "double") if floating else a.data.astype(dt)
        hit = np.isin(x, np.array(vals, dtype=dt))
        if any(isinstance(v, float) and math.isnan(v) for v in vals):
            hit |= np.isnan(x)  # a hash set matches NaN to NaN
    else:
        want = set(convert_value(v, a.type) for v in vals) if vals else set()
        hit = np.fromiter((v in want for v in a.data.tolist()), bool, count=n)
    return Arr("bool", np.where(ok, hit, has_null))


def like_regex(pattern: str, ignore_case: bool) -> "re.Pattern":
    """``pc.match_like``'s pattern: ``%`` any run, ``_`` one character, a
    backslash escapes the next; the whole value must match."""
    out, i = [], 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        out.append(".*" if ch == "%" else "." if ch == "_" else re.escape(ch))
        i += 1
    return re.compile("".join(out), re.DOTALL | (re.IGNORECASE if ignore_case else 0))


def match_like(a: Arr, pattern: str, ignore_case: bool = False) -> Arr:
    if not is_varlen(a.type):
        raise ComputeError(f"Function 'match_like' has no kernel matching input types "
                           f"({type_name(a.type)})")
    rx = like_regex(pattern, ignore_case)
    vals = a.data.tolist()
    if a.type == "binary":
        vals = [v.decode("utf-8", "surrogateescape") for v in vals]
    return Arr("bool", np.fromiter((rx.fullmatch(v) is not None for v in vals), bool,
                                   count=len(vals)), a.valid)


# -- sorting -------------------------------------------------------------------


def sort_ranks(a: Arr, ascending: bool) -> np.ndarray:
    """A rank per row that sorts as ``pc.sort_indices`` orders this key:
    values ascending or descending, then NaN, then nulls."""
    n = len(a)
    ok = a.mask()
    ranks = np.empty(n, np.int64)
    nan = np.zeros(n, bool)
    if is_floating(a.type):
        nan = ok & np.isnan(a.data.astype(np.float64))
    live = ok & ~nan
    vals = a.data[live]
    if len(vals):
        if a.type == "null" or vals.dtype == object and not is_varlen(a.type):
            raise ComputeError(f"sort on {type_name(a.type)} is not supported")
        _, inv = np.unique(vals, return_inverse=True)
        top = int(inv.max()) if len(inv) else 0
        ranks[live] = inv if ascending else top - inv
    ranks[nan] = n + 1
    ranks[~ok] = n + 2
    return ranks


def sort_indices(keys: Sequence[tuple[Arr, bool]]) -> np.ndarray:
    """A stable multi-key sort: ``keys`` are (array, ascending) pairs, the
    first the most significant."""
    if not keys:
        return np.arange(0)
    return np.lexsort([sort_ranks(a, asc) for a, asc in reversed(keys)])


def values_differ(a: Arr) -> np.ndarray:
    """Bool [n-1]: row i+1 differs from row i; nulls equal each other and
    NaN differs from NaN (``pc.not_equal`` with the nulls compared apart)."""
    ok = a.mask()
    if len(a) < 2:
        return np.zeros(0, bool)
    if a.type in NUMPY_DTYPE:
        with np.errstate(all="ignore"):
            ne = a.data[1:] != a.data[:-1]
    else:
        ne = np.fromiter((x != y for x, y in zip(a.data[1:], a.data[:-1])), bool,
                         count=len(a) - 1)
    return (ne & ok[1:] & ok[:-1]) | (ok[1:] != ok[:-1])


# -- port columns ----------------------------------------------------------------


def take_column(col: Column, idx: np.ndarray) -> Column:
    """Rows ``idx`` of a port column, of the same kind and type."""
    if isinstance(col, np.ndarray):
        return col[idx]
    if isinstance(col, VarlenColumn):
        starts = col.offsets[:-1][idx]
        lens = col.offsets[1:][idx] - starts
        offsets = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        pos = np.repeat(starts - offsets[:-1], lens) + np.arange(int(offsets[-1]))
        valid = None if col.valid is None else col.valid[idx]
        return type(col)(col.values[pos], offsets, valid)
    return ObjectColumn([col.values[i] for i in idx.tolist()], col.type)
