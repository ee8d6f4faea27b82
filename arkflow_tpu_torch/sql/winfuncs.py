"""Vectorized window-function execution over the port's columns.

Counterpart of ``arkflow_tpu/sql/winfuncs.py``: ``func(...) OVER (PARTITION
BY ... ORDER BY ...)`` columns without row-at-a-time Python. One stable
multi-key sort (``arrays.sort_indices``, pyarrow's ``sort_indices`` order:
NaN after every number, nulls last), then numpy segment arithmetic over
partition and peer boundaries, then a scatter back to input order.
Anything outside the supported surface raises ``UnsupportedSql`` and
reroutes to the sqlite fallback.

Supported: row_number, rank, dense_rank, ntile, lag, lead, first_value,
last_value, nth_value, and sum/count/avg/min/max with default frames
(whole partition when unordered; RANGE UNBOUNDED PRECEDING..CURRENT ROW,
i.e. running-with-peers, when ordered, including running min/max via a
Hillis-Steele scan). NaN follows Postgres/DataFusion ordering: a value, not
NULL; frames containing one yield NaN for sum/avg/max, min skips it.
"""

from __future__ import annotations

import numpy as np

from arkflow_tpu_torch.errors import UnsupportedSql
from arkflow_tpu_torch.sql import arrays as A
from arkflow_tpu_torch.sql import ast
from arkflow_tpu_torch.sql.arrays import Arr
from arkflow_tpu_torch.sql.functions import as_arr

_RANKING = {"row_number", "rank", "dense_rank", "ntile", "lag", "lead",
            "first_value", "last_value", "nth_value"}  # frame-free executors
_AGGS = {"sum", "count", "avg", "mean", "min", "max"}


def is_window_supported(name: str) -> bool:
    return name in _RANKING or name in _AGGS


def _int_literal_arg(f: ast.Func, i: int, default: int) -> int:
    if len(f.args) <= i:
        return default
    a = f.args[i]
    if not (isinstance(a, ast.Literal) and isinstance(a.value, int)):
        raise UnsupportedSql(f"{f.name} argument {i + 1} must be an integer literal")
    return a.value


def compute_window(win: ast.WindowFunc, ev, n: int) -> Arr:
    """Evaluate one window expression against ``ev``'s batch of ``n`` rows."""
    f = win.func
    name = "avg" if f.name == "mean" else f.name
    if not is_window_supported(name):
        raise UnsupportedSql(f"window function {f.name!r} not supported natively")
    if f.distinct:
        raise UnsupportedSql("DISTINCT inside a window function not supported natively")
    if n == 0:
        int_typed = name in ("row_number", "rank", "dense_rank", "ntile", "count")
        return A.nulls(0, "int64" if int_typed else "double")

    # one stable sort over (partition keys, order keys)
    parts = [as_arr(ev.eval(p), n) for p in win.partition_by]
    orders = [as_arr(ev.eval(oi.expr), n) for oi in win.order_by]
    keys = [(p, True) for p in parts] + [(o, oi.asc) for o, oi in zip(orders, win.order_by)]
    idx_np = A.sort_indices(keys) if keys else np.arange(n)

    # partition / peer boundaries in sorted space
    part_change = np.zeros(n - 1, bool)
    for p in parts:
        part_change |= A.values_differ(p.take(idx_np))
    peer_change = part_change.copy()
    for o in orders:
        peer_change |= A.values_differ(o.take(idx_np))
    new_part = np.r_[True, part_change]
    # without ORDER BY every partition row is a peer of every other, which
    # also makes the running-aggregate formulas degenerate to whole-partition
    new_peer = np.r_[True, peer_change] if win.order_by else new_part

    pos = np.arange(n)
    part_id = np.cumsum(new_part) - 1
    starts = np.flatnonzero(new_part)
    ends_excl = np.r_[starts[1:], n]
    part_start = starts[part_id]          # per sorted row
    part_end = ends_excl[part_id] - 1
    peer_id = np.cumsum(new_peer) - 1
    peer_starts = np.flatnonzero(new_peer)
    peer_end = np.r_[peer_starts[1:], n][peer_id] - 1

    if name in _RANKING:
        return _ranking(name, f, ev, n, idx_np, pos, part_start, part_end, peer_id,
                        peer_starts, peer_end, ends_excl, part_id)
    return _aggregate(name, f, ev, n, idx_np, part_start, peer_end)


def _scatter(values, idx_np: np.ndarray, n: int) -> Arr:
    """Reorder a sorted-space result back to input order."""
    inv = np.empty(n, np.int64)
    inv[idx_np] = np.arange(n)
    if isinstance(values, Arr):
        return values.take(inv)
    out = np.empty(n, values.dtype)
    out[idx_np] = values
    return A.from_column(out)


def _masked(values: np.ndarray, valid: np.ndarray, type_) -> Arr:
    """``pc.if_else(valid, values, null)`` of a numpy result."""
    return Arr(type_, values.astype(A.NUMPY_DTYPE[type_], copy=False), valid)


def _ranking(name, f, ev, n, idx_np, pos, part_start, part_end,
             peer_id, peer_starts, peer_end, ends_excl, part_id) -> Arr:
    if name == "row_number":
        return _scatter(pos - part_start + 1, idx_np, n)
    if name == "rank":
        return _scatter(peer_starts[peer_id] - part_start + 1, idx_np, n)
    if name == "dense_rank":
        return _scatter(peer_id - peer_id[part_start] + 1, idx_np, n)
    if name == "ntile":
        k = _int_literal_arg(f, 0, 0)
        if k <= 0:
            raise UnsupportedSql("ntile requires a positive integer argument")
        size = ends_excl[part_id] - part_start
        pos0 = pos - part_start
        q, r = size // k, size % k
        thresh = (q + 1) * r
        bucket = np.where(pos0 < thresh,
                          pos0 // np.maximum(q + 1, 1),
                          r + (pos0 - thresh) // np.maximum(q, 1))
        return _scatter(bucket + 1, idx_np, n)

    # value-bearing functions
    if not f.args:
        raise UnsupportedSql(f"{name} requires a value argument")
    vals = as_arr(ev.eval(f.args[0]), n).take(idx_np)  # sorted space
    if name in ("lag", "lead"):
        k = _int_literal_arg(f, 1, 1)
        src = pos - k if name == "lag" else pos + k
        valid = (src >= part_start) & (src <= part_end)
        taken = vals.take(np.clip(src, 0, n - 1))
        if len(f.args) >= 3:
            d = f.args[2]
            if not isinstance(d, ast.Literal):
                raise UnsupportedSql(f"{name} default must be a literal")
            fallback = A.broadcast(d.value, n)
            if fallback.type != taken.type and fallback.type != "null":
                fallback = A.cast(fallback, taken.type)
        else:
            fallback = A.nulls(n, taken.type)
        return _scatter(A.if_else(Arr("bool", valid), taken, fallback), idx_np, n)
    if name == "first_value":
        return _scatter(vals.take(part_start), idx_np, n)
    if name == "last_value":
        # default frame ends at the current row's last peer
        return _scatter(vals.take(peer_end), idx_np, n)
    if name == "nth_value":
        k = _int_literal_arg(f, 1, 0)
        if k <= 0:
            raise UnsupportedSql("nth_value requires a positive integer argument")
        src = part_start + (k - 1)
        valid = src <= peer_end  # frame = start..current peer group
        taken = vals.take(np.clip(src, 0, n - 1))
        return _scatter(A.if_else(Arr("bool", valid), taken, A.nulls(n, taken.type)),
                        idx_np, n)
    raise UnsupportedSql(f"window function {name!r} not supported natively")


def _aggregate(name, f, ev, n, idx_np, part_start, peer_end) -> Arr:
    """sum/count/avg/min/max over start..peer_end (= whole partition when
    unordered, running-with-peers when ordered) via prefix sums."""
    has_nonfinite = False
    nan_np = pinf_np = ninf_np = None
    if f.is_star:
        if name != "count":
            raise UnsupportedSql(f"{name}(*) is not a window aggregate")
        valid_np = np.ones(n, np.int64)
        x = None
        integral = False
    else:
        if len(f.args) != 1:
            raise UnsupportedSql(f"window aggregate {name} takes one argument")
        vals = as_arr(ev.eval(f.args[0]), n).take(idx_np)
        if not (A.is_numeric(vals.type) or vals.type == "bool"):
            raise UnsupportedSql(f"window {name} over non-numeric values")
        valid_b = vals.mask()
        valid_np = valid_b.astype(np.int64)
        integral = A.is_integer(vals.type) or vals.type == "bool"
        if integral:
            # exact int64 accumulation: float64 prefix sums would silently
            # round sums past 2^53
            x = np.where(valid_b, A.cast(vals, "int64").data, 0).astype(np.int64)
        else:
            x = np.where(valid_b, A.cast(vals, "double").data, 0.0)
            # NaN is a VALUE, not NULL: prefix sums would smear it into every
            # later frame, so zero it here and re-mark exactly the frames
            # whose window contains one via a NaN-count prefix. +/-inf smear
            # the same way (inf - inf = NaN in later frames), so they get the
            # same treatment with sign-correct overlays.
            if not np.isfinite(x).all():  # rare: keep the hot path lean
                has_nonfinite = True
                nan_np = np.isnan(x).astype(np.int64)
                pinf_np = (x == np.inf).astype(np.int64)
                ninf_np = (x == -np.inf).astype(np.int64)
                x = np.where((nan_np | pinf_np | ninf_np).astype(bool), 0.0, x)

    ccum = np.r_[0, np.cumsum(valid_np)]
    cnt = ccum[peer_end + 1] - ccum[part_start]
    if name == "count":
        return _scatter(cnt, idx_np, n)

    frame_nans = None
    if has_nonfinite:
        ncum = np.r_[0, np.cumsum(nan_np)]
        frame_nans = ncum[peer_end + 1] - ncum[part_start]

    if name in ("min", "max"):
        if integral:
            fill = np.iinfo(np.int64).max if name == "min" else np.iinfo(np.int64).min
            xm = np.where(valid_b, x, fill)
        elif has_nonfinite:
            fill = np.inf if name == "min" else -np.inf
            # restore genuine infinities (zeroed above for the sum path);
            # min skips NaN (it sorts above everything); max over a frame
            # holding one IS NaN, handled below via frame_nans
            xv = np.where(pinf_np.astype(bool), np.inf,
                          np.where(ninf_np.astype(bool), -np.inf, x))
            xm = np.where(valid_b & ~nan_np.astype(bool), xv, fill)
        else:
            fill = np.inf if name == "min" else -np.inf
            xm = np.where(valid_b, x, fill)
        acc = _running_extreme(xm, part_start, n, is_min=(name == "min"))
        per_row = acc[peer_end]
        if not integral and has_nonfinite:
            if name == "max":
                per_row = np.where(frame_nans > 0, np.nan, per_row)
            else:
                # all values in frame NaN -> min is NaN
                per_row = np.where((cnt > 0) & (frame_nans == cnt), np.nan, per_row)
        return _scatter(_masked(per_row, cnt > 0, "int64" if integral else "double"),
                        idx_np, n)

    scum = np.r_[0 if integral else 0.0, np.cumsum(x)]
    s = scum[peer_end + 1] - scum[part_start]
    if not integral and has_nonfinite:
        # overlay non-finite frames with IEEE semantics: +inf-only -> +inf,
        # -inf-only -> -inf, both (or any NaN) -> NaN
        pcum = np.r_[0, np.cumsum(pinf_np)]
        ncum2 = np.r_[0, np.cumsum(ninf_np)]
        fp = pcum[peer_end + 1] - pcum[part_start]
        fn = ncum2[peer_end + 1] - ncum2[part_start]
        s = np.where((fp > 0) & (fn == 0), np.inf, s)
        s = np.where((fn > 0) & (fp == 0), -np.inf, s)
        s = np.where(((fp > 0) & (fn > 0)) | (frame_nans > 0), np.nan, s)
    if name == "avg":
        with np.errstate(all="ignore"):
            avg = np.where(cnt > 0, s / np.maximum(cnt, 1), np.nan)
        return _scatter(_masked(avg, cnt > 0, "double"), idx_np, n)
    return _scatter(_masked(s, cnt > 0, "int64" if integral else "double"), idx_np, n)


def _running_extreme(xm: np.ndarray, part_start: np.ndarray, n: int,
                     is_min: bool) -> np.ndarray:
    """Per-row min/max over [part_start[i] .. i] in sorted order: a
    Hillis-Steele scan with partition resets. After k rounds acc[i] covers
    the last 2^k rows of its partition ending at i; min/max are idempotent,
    so the overlapping-window merge is exact."""
    op = np.minimum if is_min else np.maximum
    acc = xm.copy()
    pos = np.arange(n)
    shift = 1
    while shift < n:
        can = pos >= part_start + shift
        if not can.any():
            break
        shifted = np.empty_like(acc)
        shifted[shift:] = acc[:-shift]
        shifted[:shift] = acc[:shift]  # never read: 'can' is False there
        acc = np.where(can, op(acc, shifted), acc)
        shift <<= 1
    return acc
