"""Scalar/aggregate function registry: builtins + user UDFs.

Counterpart of ``arkflow_tpu/sql/functions.py`` on ``sql/arrays.py`` in
place of ``pyarrow.compute``: the same builtins, names, fallible parsers,
``NATIVE_AGGREGATES`` and UDF registry, each with the result types and
values the JAX engine's kernels give (``utf8_length`` is int32, ``floor``
of an integer is double, ``sign`` of an integer int8, ``round`` half to
even, ``strpos`` a byte position).

A builtin is a callable ``(args, n) -> Arr | scalar`` where ``args`` are
already-evaluated operands (an ``Arr`` of length n, or a Python scalar).
``as_array`` broadcasts an operand into a port column (``batch.py``).

A vectorized user UDF receives port columns where the JAX engine passes
``pa.Array``s, and may return a port column, a numpy array or a list.
"""

from __future__ import annotations

import hashlib
import json
import math
import time
from typing import Any, Callable, Sequence

import numpy as np

from arkflow_tpu_torch.batch import Column, ColumnTypeError, ObjectColumn, VarlenColumn
from arkflow_tpu_torch.errors import UnsupportedSql
from arkflow_tpu_torch.sql import arrays as A
from arkflow_tpu_torch.sql.arrays import Arr, ComputeError

ScalarFn = Callable[[Sequence[Any], int], Any]


def as_arr(v: Any, n: int) -> Arr:
    """An operand as an ``Arr`` of length n (a scalar broadcast)."""
    if isinstance(v, Arr):
        return v
    if isinstance(v, (np.ndarray, VarlenColumn, ObjectColumn)):
        return A.from_column(v)
    return A.broadcast(v, n)


def as_array(v: Any, n: int) -> Column:
    """Broadcast a Python scalar (or pass an evaluated column) into a port
    column of length n."""
    return A.to_column(as_arr(v, n))


def _all_scalar(args: Sequence[Any]) -> bool:
    return not any(isinstance(a, Arr) for a in args)


def _wrap1(kernel):
    def fn(args, n):
        (x,) = args
        if _all_scalar(args):
            return kernel(A.broadcast(x, 1)).to_pylist()[0] if x is not None else None
        return kernel(as_arr(x, n))

    return fn


def _numeric(a: Arr, name: str) -> None:
    if not A.is_numeric(a.type) and a.type != "null":
        raise ComputeError(f"Function '{name}' has no kernel matching input types "
                           f"({A.type_name(a.type)})")


def _float_fn(name: str, fn):
    """A math kernel: an integer input gives double, a float its own type."""
    def kernel(a: Arr) -> Arr:
        _numeric(a, name)
        if a.type == "null":
            return A.nulls(len(a), "double")
        t = a.type if A.is_floating(a.type) else "double"
        with np.errstate(all="ignore"):
            return Arr(t, fn(A.numeric_data(a, t)).astype(A.NUMPY_DTYPE[t]), a.valid)
    return kernel


def _abs(a: Arr) -> Arr:
    _numeric(a, "abs")
    with np.errstate(all="ignore"):
        return Arr(a.type, np.abs(a.data), a.valid)


def _sign(a: Arr) -> Arr:
    _numeric(a, "sign")
    if A.is_integer(a.type):
        return Arr("int8", np.sign(a.data).astype(np.int8), a.valid)
    x = a.data
    with np.errstate(all="ignore"):
        out = np.where(np.isnan(x), x, np.where(x > 0, 1, np.where(x < 0, -1, 0)))
    return Arr(a.type, out.astype(x.dtype), a.valid)


def round_arr(x: Arr, digits: int) -> Arr:
    """``pc.round(x, ndigits=digits)`` (half to even): a float is scaled by
    10^digits, rounded only where it has a fraction, and scaled back; an
    integer keeps its type and rounds only for negative digits."""
    _numeric(x, "round")
    if x.type == "null":
        return A.nulls(len(x), "double")
    if A.is_integer(x.type):
        if digits >= 0:
            return x
        p = 10 ** -digits
        v = x.data.astype(object)
        q = [int((d // p) * p + (p if (d % p) * 2 > p or ((d % p) * 2 == p and (d // p) % 2)
                                 else 0)) for d in v.tolist()]
        with np.errstate(all="ignore"):
            return Arr(x.type, np.array(q, dtype=object).astype(x.data.dtype), x.valid)
    dt = x.data.dtype.type
    pow10 = dt(10.0 ** abs(digits))
    with np.errstate(all="ignore"):
        scaled = x.data * pow10 if digits >= 0 else x.data / pow10
        frac = scaled - np.floor(scaled)
        r = np.rint(scaled)
        back = r / pow10 if digits > 0 else r * pow10
        out = np.where(np.isfinite(x.data) & (frac != 0), back, x.data).astype(dt)
    return Arr(x.type, out, x.valid)


def _round(args, n):
    x = as_arr(args[0], n)
    digits = int(args[1]) if len(args) > 1 else 0
    return round_arr(x, digits)


def _power(args, n):
    a, b = as_arr(args[0], n), as_arr(args[1], n)
    t = A.common_numeric(a.type, b.type)
    if t is None:
        raise ComputeError(f"Function 'power' has no kernel matching input types "
                           f"({A.type_name(a.type)}, {A.type_name(b.type)})")
    x, y = A.numeric_data(a, t), A.numeric_data(b, t)
    valid = A.both_valid(a, b)
    live = np.ones(n, bool) if valid is None else valid
    with np.errstate(all="ignore"):
        if A.is_integer(t):
            if (y[live] < 0).any():
                raise ComputeError("integers to negative integer powers are not allowed")
            out = np.power(x, np.where(y < 0, 0, y))
        else:
            out = np.power(x, y)
    return Arr(t, out.astype(A.NUMPY_DTYPE[t]), valid)


# -- string helpers --------------------------------------------------------


def _text_kernel(name: str, fn, out_type="string", binary_ok=False):
    """A row-wise kernel over a string column (binary too where ``pc``
    takes it); null rows stay null."""
    def kernel(a: Arr) -> Arr:
        if a.type == "null":
            return A.nulls(len(a), out_type)
        if not (a.type == "string" or (binary_ok and a.type == "binary")):
            raise ComputeError(f"Function '{name}' has no kernel matching input types "
                               f"({A.type_name(a.type)})")
        t = out_type
        vals = [fn(v) for v in a.data.tolist()]
        data = np.array(vals, dtype=A.NUMPY_DTYPE[t]) if t in A.NUMPY_DTYPE else A.objects(vals)
        return Arr(t, data, a.valid)
    return kernel


def _upper_char(c: str) -> str:
    u = c.upper()
    return u if len(u) == 1 else ("\u1e9e" if c == "\u00df" else c)


def _lower_char(c: str) -> str:
    lo = c.lower()
    return lo if len(lo) == 1 else c


def _substr(args, n):
    s = as_arr(args[0], n)
    start = args[1] if not isinstance(args[1], Arr) else None
    if start is None:
        raise UnsupportedSql("substr start must be a literal")
    start = int(start)
    py_start = start - 1 if start > 0 else 0  # SQL is 1-based
    if len(args) >= 3:
        length = int(args[2])
        return _text_kernel("utf8_slice_codeunits",
                            lambda v: v[py_start:py_start + length])(s)
    return _text_kernel("utf8_slice_codeunits", lambda v: v[py_start:])(s)


def _concat(args, n):
    arrs = [A.cast(as_arr(a, n), "string") for a in args]
    vals = ["".join(parts) for parts in zip(*[a.data.tolist() for a in arrs])]
    return Arr("string", A.objects(vals))


def _coalesce(args, n):
    out = as_arr(args[0], n)
    for a in args[1:]:
        out = A.if_else(A.is_valid(out), out, as_arr(a, n))
    return out


def _nullif(args, n):
    a, b = as_arr(args[0], n), as_arr(args[1], n)
    return A.if_else(A.compare("=", a, b), A.nulls(n, a.type), a)


def _split_part(args, n):
    s, sep, idx = as_arr(args[0], n), str(args[1]), int(args[2])
    i = idx - 1
    out = []
    for v, ok in zip(s.data.tolist(), s.mask()):
        if not ok:
            out.append("")
            continue
        parts = v.split(sep)
        if not 0 <= i < len(parts):
            raise ComputeError(f"Index {i} is out of bounds: should be in [0, {len(parts)})")
        out.append(parts[i])
    return Arr("string", A.objects(out), s.valid)


def _json_get(args, n, extract=None):
    """Row-wise JSON field extraction from a string/binary column (fallback-speed)."""
    s = as_arr(args[0], n)
    key = args[1]
    if isinstance(key, Arr):
        raise UnsupportedSql("json key must be a literal")
    out = []
    for pv in s.to_pylist():
        if pv is None:
            out.append(None)
            continue
        if isinstance(pv, bytes):
            pv = pv.decode("utf-8", "replace")
        try:
            doc = json.loads(pv)
            cur: Any = doc
            for part in str(key).split("."):
                if isinstance(cur, dict):
                    cur = cur.get(part)
                elif isinstance(cur, list) and part.lstrip("-").isdigit():
                    i = int(part)
                    cur = cur[i] if -len(cur) <= i < len(cur) else None
                else:
                    cur = None
            out.append(extract(cur) if extract else cur)
        except (ValueError, TypeError):
            out.append(None)
    if extract is None:
        out = [json.dumps(v) if isinstance(v, (dict, list)) else v for v in out]
        try:
            # homogeneous scalars keep their JSON type (json_get_dyn, which
            # only VRL lowers to); mixed types fall back to the string form
            return A.from_pylist(out)
        except ColumnTypeError:
            return A.from_pylist([None if v is None else str(v) for v in out], "string")
    return A.from_pylist(out)


def _json_to_str(v):
    """Stable string form for the SQL-facing json_get: JSON text for
    containers/bools, plain text for scalars, NULL stays NULL."""
    if v is None:
        return None
    if isinstance(v, (dict, list, bool)):
        return json.dumps(v)
    return str(v)


def _split(args, n):
    """split(text, sep) -> list<string> column (VRL's split)."""
    s, sep = as_arr(args[0], n), str(args[1])
    if s.type == "binary":  # pc.split_pattern splits binary into list<binary>
        sep = sep.encode()
    vals = [v.split(sep) if ok else None for v, ok in zip(s.data.tolist(), s.mask())]
    return Arr(("list", s.type if s.type != "null" else "string"), A.objects(vals), s.valid)


def _join(args, n):
    """join(list, sep) -> string column (a null list or element gives null)."""
    arr, sep = as_arr(args[0], n), str(args[1])
    out = []
    for v in arr.to_pylist():
        out.append(None if v is None or any(x is None for x in v)
                   else sep.join(x.decode() if isinstance(x, bytes) else x for x in v))
    return A.from_pylist(out, "string")


def _list_get(args, n):
    """list_get(list, i) -> element i (0-based; out-of-range/null -> NULL)."""
    arr = as_arr(args[0], n)
    idx = args[1]
    if isinstance(idx, Arr):
        raise UnsupportedSql("list index must be a literal")
    idx = int(idx)
    if not isinstance(arr.type, tuple) or arr.type[0] not in ("list", "fixed_size_list"):
        raise ComputeError(f"list_get needs a list column, got {A.type_name(arr.type)}")
    out = [pv[idx] if pv is not None and -len(pv) <= idx < len(pv) else None
           for pv in arr.to_pylist()]
    # the element type is pinned: an all-out-of-range batch keeps its type
    return A.from_pylist(out, arr.type[1])


def _merge(args, n):
    """merge(a, b) -> shallow-merged JSON object text (b's keys win); an
    invalid/non-object operand is the empty object; NULL only when both
    operands are invalid/NULL."""
    a, b = as_arr(args[0], n), as_arr(args[1], n)

    def load(pv):
        if pv is None:
            return None
        if isinstance(pv, bytes):
            pv = pv.decode("utf-8", "replace")
        try:
            doc = json.loads(pv)
        except (ValueError, TypeError):
            return None
        return doc if isinstance(doc, dict) else None

    out = []
    for va, vb in zip(a.to_pylist(), b.to_pylist()):
        da, db = load(va), load(vb)
        out.append(None if da is None and db is None
                   else json.dumps({**(da or {}), **(db or {})}))
    return A.from_pylist(out, "string")


def _encode_json(args, n):
    """encode_json(x) -> JSON text per row (integers and bools through the
    cast, whose text is their JSON); NULL stays NULL."""
    arr = as_arr(args[0], n)
    if arr.type == "bool" or A.is_integer(arr.type):
        return A.cast(arr, "string")

    def debytes(pv):
        if isinstance(pv, bytes):
            return pv.decode("utf-8", "replace")
        if isinstance(pv, list):
            return [debytes(x) for x in pv]
        if isinstance(pv, dict):
            return {debytes(k): debytes(v) for k, v in pv.items()}
        return pv

    return A.from_pylist([None if v is None else json.dumps(debytes(v), default=str)
                          for v in arr.to_pylist()], "string")


def _mod(args, n):
    a, b = as_arr(args[0], n), as_arr(args[1], n)
    q = A.arith("/", A.promote(a, "double"), A.promote(b, "double"))
    fl = _float_fn("floor", np.floor)(q)
    return A.arith("-", a, A.arith("*", A.cast_checked(fl, b.type), b))


def _element_wise(args, n, is_max: bool):
    """``pc.max_element_wise`` / ``min_element_wise``: nulls and NaN skipped."""
    arrs = [as_arr(a, n) for a in args]
    t = arrs[0].type
    for a in arrs[1:]:
        t = A.common_type(t, a.type)
    arrs = [A.promote(a, t) for a in arrs]
    out = []
    for row in zip(*[a.to_pylist() for a in arrs]):
        vals = [v for v in row if v is not None and not (isinstance(v, float) and math.isnan(v))]
        if not vals:
            nan = [v for v in row if v is not None]
            out.append(nan[0] if nan else None)
        else:
            out.append(max(vals) if is_max else min(vals))
    return A.from_pylist(out, t)


def _strpos(args, n):
    s, pat = as_arr(args[0], n), str(args[1])
    enc = pat.encode()
    found = _text_kernel("find_substring", lambda v: v.encode().find(enc), "int32")(s)
    return A.arith("+", found, A.broadcast(1, n))


def _pad(left: bool):
    def fn(args, n):
        width = int(args[1])
        pad = str(args[2]) if len(args) > 2 else " "
        return _text_kernel("utf8_lpad" if left else "utf8_rpad",
                            lambda v: v.rjust(width, pad) if left else v.ljust(width, pad))(
            as_arr(args[0], n))
    return fn


def _bool_text(name: str, test):
    def fn(args, n):
        pat = str(args[1])
        return _text_kernel(name, lambda v: test(v, pat if isinstance(v, str) else pat.encode()),
                            "bool", binary_ok=True)(as_arr(args[0], n))
    return fn


_BUILTINS: dict[str, ScalarFn] = {
    # math
    "abs": _wrap1(_abs),
    "ceil": _wrap1(_float_fn("ceil", np.ceil)),
    "ceiling": _wrap1(_float_fn("ceil", np.ceil)),
    "floor": _wrap1(_float_fn("floor", np.floor)),
    "sqrt": _wrap1(_float_fn("sqrt", np.sqrt)),
    "exp": _wrap1(_float_fn("exp", np.exp)),
    "ln": _wrap1(_float_fn("ln", np.log)),
    "log10": _wrap1(_float_fn("log10", np.log10)),
    "log2": _wrap1(_float_fn("log2", np.log2)),
    "sign": _wrap1(_sign),
    "round": _round,
    "power": _power,
    "pow": _power,
    "mod": _mod,
    # string
    "upper": _wrap1(_text_kernel("utf8_upper", lambda v: "".join(map(_upper_char, v)))),
    "lower": _wrap1(_text_kernel("utf8_lower", lambda v: "".join(map(_lower_char, v)))),
    "length": _wrap1(_text_kernel("utf8_length", len, "int32")),
    "char_length": _wrap1(_text_kernel("utf8_length", len, "int32")),
    "character_length": _wrap1(_text_kernel("utf8_length", len, "int32")),
    "octet_length": _wrap1(_text_kernel(
        "binary_length", lambda v: len(v.encode() if isinstance(v, str) else v), "int32",
        binary_ok=True)),
    "trim": _wrap1(_text_kernel("utf8_trim_whitespace", str.strip)),
    "ltrim": _wrap1(_text_kernel("utf8_ltrim_whitespace", str.lstrip)),
    "rtrim": _wrap1(_text_kernel("utf8_rtrim_whitespace", str.rstrip)),
    "reverse": _wrap1(_text_kernel("utf8_reverse", lambda v: v[::-1])),
    "substr": _substr,
    "substring": _substr,
    "concat": _concat,
    "replace": lambda args, n: _text_kernel(
        "replace_substring", lambda v: v.replace(str(args[1]), str(args[2])))(
        as_arr(args[0], n)),
    "starts_with": _bool_text("starts_with", lambda v, p: v.startswith(p)),
    "ends_with": _bool_text("ends_with", lambda v, p: v.endswith(p)),
    "strpos": _strpos,
    "lpad": _pad(True),
    "rpad": _pad(False),
    "split_part": _split_part,
    # list / object tier (VRL split/join/merge/encode_json)
    "split": _split,
    "join": _join,
    "array_join": _join,
    "list_get": _list_get,
    "merge": _merge,
    "encode_json": _encode_json,
    # null handling / misc
    "coalesce": _coalesce,
    "ifnull": _coalesce,
    "nvl": _coalesce,
    "nullif": _nullif,
    "greatest": lambda args, n: _element_wise(args, n, True),
    "least": lambda args, n: _element_wise(args, n, False),
    # time
    "now": lambda args, n: time.time(),
    "unix_millis": lambda args, n: int(time.time() * 1000),
    "current_timestamp": lambda args, n: time.time(),
    # json (for the __value__ payload column)
    "json_get": lambda args, n: _json_get(args, n, extract=_json_to_str),
    "json_get_dyn": lambda args, n: _json_get(args, n),
    "json_get_str": lambda args, n: _json_get(args, n, extract=lambda v: None if v is None else str(v)),
    "json_get_int": lambda args, n: _json_get(args, n, extract=lambda v: int(v) if isinstance(v, (int, float)) and not isinstance(v, bool) else None),
    "json_get_float": lambda args, n: _json_get(args, n, extract=lambda v: float(v) if isinstance(v, (int, float)) and not isinstance(v, bool) else None),
    "json_get_bool": lambda args, n: _json_get(args, n, extract=lambda v: v if isinstance(v, bool) else None),
    # VRL-style fallible parsers: failures become NULL, so the VRL idiom
    # `to_int(.x) ?? 0` maps to `coalesce(parse_int(x), 0)`
    "parse_int": lambda args, n: _parse_int(args, n),
    "parse_float": lambda args, n: _rowwise1(args, n, _to_float),
    "parse_timestamp": lambda args, n: _parse_timestamp(args, n),
    "format_timestamp": lambda args, n: _format_timestamp(args, n),
    "regex_match": lambda args, n: _regex_match(args, n),
    "regex_extract": lambda args, n: _regex_extract(args, n),
    "parse_key_value": lambda args, n: _parse_key_value(args, n),
    "parse_url": lambda args, n: _parse_url(args, n),
    "parse_syslog": lambda args, n: _parse_syslog(args, n),
    "md5": lambda args, n: _rowwise1(args, n, lambda v: hashlib.md5(_as_bytes(v)).hexdigest(), raw=True),
    "sha256": lambda args, n: _rowwise1(args, n, lambda v: hashlib.sha256(_as_bytes(v)).hexdigest(), raw=True),
    "to_string": lambda args, n: _rowwise1(args, n, str),
}

# -- VRL-style fallible parser implementations ------------------------------


def _pylist(v, n):
    return as_arr(v, n).to_pylist()


def _as_bytes(v):
    """Hash inputs keep their raw bytes; strings hash their utf-8 encoding."""
    return bytes(v) if isinstance(v, (bytes, bytearray)) else str(v).encode()


def _rowwise1(args, n, fn, raw=False):
    out = []
    for v in _pylist(args[0], n):
        if v is None:
            out.append(None)
            continue
        if isinstance(v, bytes) and not raw:
            v = v.decode(errors="replace")
        try:
            out.append(fn(v))
        except Exception:
            # the fallible-parser contract: a bad row yields NULL, never
            # aborts the batch
            out.append(None)
    return A.from_pylist(out)


def _to_float(v):
    return float(v)


def _parse_int(args, n):
    base = int(args[1]) if len(args) > 1 else 10

    def conv(v):
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return int(v)
        return int(str(v).strip(), base)

    return _rowwise1(args, n, conv)


def _parse_timestamp(args, n):
    """parse_timestamp(x, fmt) -> epoch seconds (UTC) or NULL."""
    import calendar
    import time as _t

    fmt = str(args[1]) if len(args) > 1 else "%Y-%m-%dT%H:%M:%S"

    def conv(v):
        return float(calendar.timegm(_t.strptime(str(v).strip(), fmt)))

    return _rowwise1(args, n, conv)


def _format_timestamp(args, n):
    import time as _t

    fmt = str(args[1]) if len(args) > 1 else "%Y-%m-%dT%H:%M:%S"
    return _rowwise1(args, n, lambda v: _t.strftime(fmt, _t.gmtime(float(v))))


_REGEX_CACHE: dict[str, Any] = {}


def _compiled(pattern: str):
    import re

    rx = _REGEX_CACHE.get(pattern)
    if rx is None:
        rx = _REGEX_CACHE[pattern] = re.compile(pattern)
    return rx


def _regex_match(args, n):
    rx = _compiled(str(args[1]))
    return _rowwise1(args, n, lambda v: rx.search(str(v)) is not None)


def _regex_extract(args, n):
    """regex_extract(x, pattern [, group]) — group index or name; default 1
    when the pattern has groups, else the whole match."""
    rx = _compiled(str(args[1]))
    group: Any = args[2] if len(args) > 2 else (1 if rx.groups else 0)
    if isinstance(group, float):
        group = int(group)

    def conv(v):
        m = rx.search(str(v))
        return None if m is None else m.group(group)

    return _rowwise1(args, n, conv)


def _split_pairs(text: str, pair_sep: str):
    """Split on pair_sep outside double quotes (logfmt quoting)."""
    out, cur, quoted = [], [], False
    i, sep_len = 0, len(pair_sep)
    while i < len(text):
        ch = text[i]
        if quoted and ch == "\\" and i + 1 < len(text):
            cur.append(ch)
            cur.append(text[i + 1])  # escaped char (incl. \") stays in-value
            i += 2
        elif ch == '"':
            quoted = not quoted
            cur.append(ch)
            i += 1
        elif not quoted and text.startswith(pair_sep, i):
            out.append("".join(cur))
            cur = []
            i += sep_len
        else:
            cur.append(ch)
            i += 1
    out.append("".join(cur))
    return out


def _parse_key_value(args, n):
    """parse_key_value(x, key [, pair_sep, kv_sep]) — logfmt-style lookup;
    double-quoted values may contain the pair separator."""
    key = str(args[1])
    pair_sep = str(args[2]) if len(args) > 2 else " "
    kv_sep = str(args[3]) if len(args) > 3 else "="

    import re as _re

    def conv(v):
        for pair in _split_pairs(str(v), pair_sep):
            k, sep, val = pair.partition(kv_sep)
            if sep and k.strip() == key:
                val = val.strip()
                if len(val) >= 2 and val[0] == '"' and val[-1] == '"':
                    val = val[1:-1]  # the delimiting quotes only
                return _re.sub(r"\\(.)", r"\1", val)  # \" -> ", \\ -> \
        return None

    return _rowwise1(args, n, conv)


_SYSLOG_3164 = None
_SYSLOG_5424 = None


def _parse_syslog(args, n):
    """parse_syslog(line, part): RFC 5424 and legacy RFC 3164 lines.
    Parts: severity, facility, timestamp, hostname, appname, procid, msgid,
    message, version. Unparseable rows -> NULL. (The JAX engine runs one
    RE2 pass a pattern where pyarrow can; its rows equal this row-wise
    form, which it keeps as its reference.)"""
    global _SYSLOG_3164, _SYSLOG_5424
    import re as _re

    if _SYSLOG_5424 is None:
        _SYSLOG_5424 = _re.compile(
            r"^<(?P<pri>\d{1,3})>(?P<version>\d)\s+"
            r"(?P<timestamp>\S+)\s+(?P<hostname>\S+)\s+(?P<appname>\S+)\s+"
            r"(?P<procid>\S+)\s+(?P<msgid>\S+)\s+"
            r"(?P<sd>-|(?:\[.*?\])+)\s*(?P<message>.*)$", _re.DOTALL)
        _SYSLOG_3164 = _re.compile(
            r"^<(?P<pri>\d{1,3})>"
            r"(?P<timestamp>[A-Z][a-z]{2}\s+\d{1,2}\s\d{2}:\d{2}:\d{2})\s+"
            r"(?P<hostname>\S+)\s+"
            r"(?P<appname>[^\s:\[]+)(?:\[(?P<procid>\d+)\])?:?\s*"
            r"(?P<message>.*)$", _re.DOTALL)
    s = as_arr(args[0], n)
    key = args[1]
    if isinstance(key, Arr):
        raise UnsupportedSql("parse_syslog part must be a literal")
    key = str(key)

    def one(v):
        if v is None:
            return None
        if isinstance(v, bytes):
            v = v.decode("utf-8", "replace")
        try:
            m = _SYSLOG_5424.match(v) or _SYSLOG_3164.match(v)
        except TypeError:
            return None
        if m is None:
            return None
        d = m.groupdict()
        pri = int(d["pri"])
        if key == "severity":
            return pri & 7
        if key == "facility":
            return pri >> 3
        if key == "version":
            return int(d["version"]) if d.get("version") else None
        val = d.get(key)
        return None if val in (None, "-") else val

    raw = s.to_pylist()
    vals = [one(v) for v in raw]
    if not _syslog_vectorizable(s, raw):
        # JAX's row-wise path: the type inferred from the values
        return A.from_pylist(vals)
    if key in ("severity", "facility", "version"):
        return A.from_pylist(vals, "int64")
    return A.from_pylist(vals, "string")


def _syslog_vectorizable(s: Arr, raw: list) -> bool:
    """Whether JAX's vectorized ``parse_syslog`` serves this input (whose
    result types are pinned): a string column, or a binary one that is all
    valid UTF-8; anything else takes its row-wise path."""
    if s.type == "string":
        return True
    if s.type != "binary":
        return False
    try:
        for v in raw:
            if v is not None:
                v.decode("utf-8")
    except UnicodeDecodeError:
        return False
    return True


def _parse_url(args, n):
    from urllib.parse import urlparse

    part = str(args[1]) if len(args) > 1 else "host"

    def conv(v):
        u = urlparse(str(v))
        val = {"scheme": u.scheme, "host": u.hostname, "port": u.port,
               "path": u.path, "query": u.query, "fragment": u.fragment,
               "username": u.username}.get(part)
        return None if val in (None, "") else val

    return _rowwise1(args, n, conv)


#: Aggregates the native GROUP BY planner runs (``planner._aggregate``),
#: by the names of the pyarrow hash kernels the JAX planner maps them onto.
NATIVE_AGGREGATES = {
    "count": "count",
    "sum": "sum",
    "min": "min",
    "max": "max",
    "avg": "mean",
    "mean": "mean",
    "stddev": "stddev",
    "variance": "variance",
    "var": "variance",
    "first_value": "first",
    "last_value": "last",
    "approx_distinct": "count_distinct",
}

# -- user UDFs -------------------------------------------------------------

_SCALAR_UDFS: dict[str, tuple[Callable, bool]] = {}
_AGGREGATE_UDFS: dict[str, Callable] = {}


def register_scalar_udf(name: str, fn: Callable, vectorized: bool = False) -> None:
    """Register a scalar UDF usable from any SQL processor.

    ``vectorized=True``: ``fn(*port_columns) -> column, numpy array or list``.
    ``vectorized=False``: ``fn(*python_scalars) -> python scalar`` applied row-wise.
    """
    _SCALAR_UDFS[name.lower()] = (fn, vectorized)


def register_aggregate_udf(name: str, fn: Callable) -> None:
    """Register an aggregate UDF: ``fn(list_of_python_values) -> scalar``."""
    _AGGREGATE_UDFS[name.lower()] = fn


def get_aggregate_udf(name: str):
    return _AGGREGATE_UDFS.get(name.lower())


def scalar_udfs() -> dict[str, tuple[Callable, bool]]:
    return dict(_SCALAR_UDFS)


def udf_result(out: Any, n: int) -> Arr:
    """A vectorized UDF's return value as an ``Arr``."""
    if isinstance(out, Arr):
        return out
    if isinstance(out, (np.ndarray, VarlenColumn, ObjectColumn)):
        return A.from_column(out)
    if isinstance(out, (list, tuple)):
        return A.from_pylist(list(out))
    return A.broadcast(out, n)


def call_scalar(name: str, args: Sequence[Any], n: int) -> Any:
    """Dispatch a scalar function call: builtins first, then UDFs."""
    fn = _BUILTINS.get(name)
    if fn is not None:
        return fn(args, n)
    udf = _SCALAR_UDFS.get(name)
    if udf is not None:
        f, vectorized = udf
        if vectorized:
            return udf_result(f(*[as_array(a, n) for a in args]), n)
        cols = [as_arr(a, n).to_pylist() for a in args]
        return A.from_pylist([f(*row) for row in zip(*cols)] if cols else [f() for _ in range(n)])
    raise UnsupportedSql(f"unknown function {name!r}")


def has_function(name: str) -> bool:
    return name in _BUILTINS or name in _SCALAR_UDFS
