"""VRL (Vector Remap Language), compiled onto the port's columnar engine.

Counterpart of ``arkflow_tpu/sql/vrl.py``: the same lexer, parser and step
plan, run on the port's batches and the kernels of ``sql/arrays.py``
instead of ``pyarrow.compute``. A program compiles once into vectorized
steps over whole columns; anything outside the subset raises
``VrlCompileError`` (a ``ConfigError``) at build with JAX's message.

Supported surface (JAX's):

- field assignment ``.out = expr`` (top-level and dotted display names)
- local variables ``tmp = expr``, bound by value at assignment time as
  hidden columns, so a later write to their source field cannot change them
- ``del(.field)``
- ``if cond { ... } else if ... { ... } else { ... }``: the branch masks are
  taken when the statement is reached (a null condition routes to else),
  assignments in a branch are masked writes, ``abort`` is a row filter
- operators ``== != < <= > >= && || ! + - * / % ??`` (Kleene ``&&`` and
  ``||``, ``!null`` is null, ``??`` is ``coalesce``), literals, parens,
  ``r'...'`` regex literals
- the fallible-call forms ``f!(...)`` and ``f(...) ?? default``
- object-returning parsers used with a path: ``parse_json!(.m).a.b``,
  ``parse_url!(.u).host``, ``parse_key_value!(.l).level``,
  ``parse_regex!(.x, r'(?P<g>..)').g``, ``parse_syslog!(.line).part``
- the stdlib of ``sql/functions.py`` (``_FN`` below)
- lists: ``split``, ``join``, postfix ``[i]`` (negative from the end, out
  of range null), ``merge`` and ``encode_json``
- whole-event ``. = parse_json!(.col)``: the object's keys become the
  event's columns, typed as the json codec types them; ``__meta_*`` and
  locals survive
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

import numpy as np

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.errors import ArkError, ConfigError
from arkflow_tpu_torch.sql import arrays as A
from arkflow_tpu_torch.sql import ast
from arkflow_tpu_torch.sql.arrays import Arr
from arkflow_tpu_torch.sql.eval import Evaluator
from arkflow_tpu_torch.sql.functions import as_arr


class VrlCompileError(ConfigError):
    """VRL program outside the supported subset (build-time)."""


# ---------------------------------------------------------------------------
# lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>[ \t]+)
  | (?P<comment>\#[^\n]*)
  | (?P<nl>[\r\n]+)
  | (?P<regex>r'(?:[^'\\]|\\.)*')
  | (?P<string>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<number>\d+\.\d+|\d+)
  | (?P<path>\.(?:[A-Za-z_][A-Za-z0-9_]*(?:\.[A-Za-z_][A-Za-z0-9_]*)*)?)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*!?)
  | (?P<op>\?\?|==|!=|<=|>=|&&|\|\||[-+*/%<>=!(){},;:\[\]])
    """,
    re.VERBOSE,
)


@dataclass
class _Tok:
    kind: str  # nl string regex number path ident op eof
    value: str
    pos: int


def _lex(src: str) -> list[_Tok]:
    toks: list[_Tok] = []
    i = 0
    while i < len(src):
        m = _TOKEN_RE.match(src, i)
        if m is None:
            raise VrlCompileError(f"vrl: unexpected character {src[i]!r} at {i}")
        kind = m.lastgroup
        i = m.end()
        if kind in ("ws", "comment"):
            continue
        toks.append(_Tok(kind, m.group(), m.start()))
    toks.append(_Tok("eof", "", len(src)))
    return toks


def _unquote(s: str) -> str:
    body = s[1:-1]
    return re.sub(r"\\(.)", lambda m: {"n": "\n", "t": "\t", "r": "\r"}.get(
        m.group(1), m.group(1)), body)


# ---------------------------------------------------------------------------
# compiled plan
# ---------------------------------------------------------------------------

# steps: ("mask", slot, cond_expr, parent_slot|None)   — branch-entry snapshot
#      | ("maskelse", slot, then_slot, parent_slot|None) — parent AND NOT then
#      | ("assign", col, expr) | ("cassign", col, slot, value)
#      | ("del", col) | ("filter", slot|None)          — abort; None = all rows
#
# Branch conditions are evaluated ONCE into a numbered mask slot when the
# if-statement is reached (VRL row semantics: a row's branch choice is fixed
# before the branch body mutates anything). Body steps then reference the
# slot instead of re-evaluating the condition against the mutated batch —
# re-evaluation would skip later statements whenever a branch assigned to a
# column its own condition read.
Step = tuple

# hidden-column prefix for materialized local variables (stripped from the
# output batch). Locals bind their VALUE at assignment time (VRL semantics);
# textual inlining would re-read mutated source columns.
_LOCAL_PREFIX = "__vrl_"


# VRL function name -> (sql function name, arity range)
_FN = {
    "to_int": "parse_int", "int": "parse_int",
    "to_float": "parse_float", "float": "parse_float",
    "to_string": "to_string", "string": "to_string",
    "upcase": "upper", "downcase": "lower",
    "trim": "trim", "strip_whitespace": "trim",
    "replace": "replace", "length": "length", "strlen": "length",
    "round": "round", "abs": "abs", "floor": "floor", "ceil": "ceil",
    "md5": "md5", "sha2": "sha256", "sha256": "sha256",
    "match": "regex_match",
    "parse_timestamp": "parse_timestamp",
    "format_timestamp": "format_timestamp",
    "parse_int": "parse_int", "parse_float": "parse_float",
    "starts_with": "starts_with", "ends_with": "ends_with",
    "now": "now", "coalesce": "coalesce",
    "split_part": "split_part",
    # list/object tier: Arrow list columns + row-wise JSON (functions.py)
    "split": "split", "join": "join",
    "merge": "merge", "encode_json": "encode_json",
}

# object-returning parsers: path access becomes an extra key argument
_OBJECT_FNS = {"parse_json", "parse_url", "parse_key_value", "parse_regex",
               "parse_syslog"}

# hints for constructs with no columnar form, named in the refusal
_UNSUPPORTED_HINTS: dict[str, str] = {}


class _Parser:
    def __init__(self, src: str):
        self.toks = _lex(src)
        self.i = 0
        self._mask_slots = 0

    def _new_slot(self) -> int:
        self._mask_slots += 1
        return self._mask_slots - 1

    def peek(self, skip_nl: bool = True) -> _Tok:
        j = self.i
        while skip_nl and self.toks[j].kind == "nl":
            j += 1
        return self.toks[j]

    def next(self, skip_nl: bool = True) -> _Tok:
        while skip_nl and self.toks[self.i].kind == "nl":
            self.i += 1
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept_op(self, *ops: str) -> Optional[_Tok]:
        t = self.peek()
        if t.kind == "op" and t.value in ops:
            return self.next()
        return None

    def expect_op(self, op: str) -> _Tok:
        t = self.next()
        if not (t.kind == "op" and t.value == op):
            raise VrlCompileError(f"vrl: expected {op!r} at {t.pos}, got {t.value!r}")
        return t

    # -- program -----------------------------------------------------------

    def parse_program(self) -> list[Step]:
        steps: list[Step] = []
        env: dict[str, ast.Expr] = {}
        while self.peek().kind != "eof":
            if self.accept_op(";"):
                continue
            # a bare trailing '.' (VRL's "return the event") is a no-op here
            t = self.peek()
            if t.kind == "path" and t.value == ".":
                nxt = self.toks[self._index_after(t)]
                if nxt.kind in ("eof", "nl") or (nxt.kind == "op" and nxt.value == ";"):
                    self.next()
                    continue
            steps.extend(self._statement(env))
        return steps

    def _index_after(self, tok: _Tok) -> int:
        for j in range(self.i, len(self.toks)):
            if self.toks[j] is tok:
                return j + 1
        return len(self.toks) - 1

    def _statement(self, env: dict[str, ast.Expr],
                   cond_slot: Optional[int] = None) -> list[Step]:
        t = self.peek()
        if t.kind == "ident" and t.value == "if":
            return self._if_statement(env, cond_slot)
        if t.kind == "ident" and t.value == "abort":
            self.next()
            return [("filter", cond_slot)]
        if t.kind == "ident" and t.value in ("del", "del!"):
            self.next()
            self.expect_op("(")
            p = self.next()
            if p.kind != "path" or p.value == ".":
                raise VrlCompileError(f"vrl: del() needs a field path at {p.pos}")
            self.expect_op(")")
            if cond_slot is not None:
                raise VrlCompileError(
                    "vrl: del() inside if-branches is not supported; "
                    "assign null instead")
            return [("del", p.value[1:])]
        if t.kind == "path":
            self.next()
            if t.value == ".":
                # whole-event assignment: `. = parse_json!(.col)` replaces
                # the event with the parsed object's columns (metadata and
                # locals survive, like VRL's separately-held metadata)
                self.expect_op("=")
                fn = self.next()
                if not (fn.kind == "ident" and fn.value.rstrip("!") == "parse_json"):
                    raise VrlCompileError(
                        "vrl: whole-event assignment supports "
                        "'. = parse_json!(<expr>)' (other object sources "
                        "have no columnar form)")
                self.expect_op("(")
                inner = self._expr(env)
                self.expect_op(")")
                if cond_slot is not None:
                    raise VrlCompileError(
                        "vrl: '. = parse_json!(..)' inside if-branches is "
                        "not supported (the event schema must not depend on "
                        "the row)")
                return [("expand", inner)]
            # '.out, err = expr': VRL's error-capture tuple. Fallible ops
            # here yield NULL instead of an error value, so err binds null.
            err_var = None
            if self.accept_op(","):
                ev_tok = self.next()
                if ev_tok.kind != "ident":
                    raise VrlCompileError(
                        f"vrl: expected error variable after ',' at {ev_tok.pos}")
                err_var = ev_tok.value
            self.expect_op("=")
            e = self._expr(env)
            if err_var is not None:
                env[err_var] = ast.Literal(None)
            col = t.value[1:]
            if cond_slot is not None:
                return [("cassign", col, cond_slot, e)]
            return [("assign", col, e)]
        if t.kind == "ident":
            # local variable binding: bind the VALUE now by materializing a
            # hidden column (literals stay inline — nothing can mutate them)
            save = self.i
            name = self.next()
            if self.accept_op("="):
                if self.peek().kind == "op" and self.peek().value == "=":
                    raise VrlCompileError(f"vrl: '==' at statement level at {name.pos}")
                e = self._expr(env)
                # the literal inline shortcut is only sound at top level: a
                # literal bound inside a branch must land on the branch's rows
                # only, so it rides the masked cassign path
                if isinstance(e, ast.Literal) and cond_slot is None:
                    env[name.value] = e
                    return []
                hidden = _LOCAL_PREFIX + name.value
                steps: list[Step] = []
                if cond_slot is not None:
                    # non-matching rows must keep the pre-branch value, so the
                    # prior binding is materialized into the hidden column
                    # before the masked write (unbound-before -> null, which
                    # is what cassign's missing-column base already yields)
                    prior = env.get(name.value)
                    if prior is not None and not (
                            isinstance(prior, ast.Column) and prior.name == hidden):
                        steps.append(("assign", hidden, prior))
                    steps.append(("cassign", hidden, cond_slot, e))
                else:
                    steps.append(("assign", hidden, e))
                env[name.value] = ast.Column(hidden)
                return steps
            self.i = save
        raise VrlCompileError(f"vrl: unsupported statement at {t.pos}: {t.value!r}")

    def _if_statement(self, env: dict[str, ast.Expr],
                      parent_slot: Optional[int]) -> list[Step]:
        self.next()  # 'if'
        cond = self._expr(env)
        # snapshot BOTH polarities before any body step runs: a then-branch
        # that assigns to a condition column must not flip rows into/out of
        # its own else-branch
        then_slot = self._new_slot()
        steps: list[Step] = [("mask", then_slot, cond, parent_slot)]
        else_slot: Optional[int] = None
        body = self._block(env, then_slot)
        if self.peek().kind == "ident" and self.peek().value == "else":
            else_slot = self._new_slot()
            # else = parent AND NOT then-mask (not `not cond`): the then-mask
            # is null-filled, so rows whose condition is null fall into else,
            # matching VRL's null-is-false predicate
            steps.append(("maskelse", else_slot, then_slot, parent_slot))
        steps.extend(body)
        if else_slot is not None:
            self.next()  # 'else'
            if self.peek().kind == "ident" and self.peek().value == "if":
                steps.extend(self._if_statement(env, else_slot))
            else:
                steps.extend(self._block(env, else_slot))
        return steps

    def _block(self, env: dict[str, ast.Expr], cond_slot: int) -> list[Step]:
        self.expect_op("{")
        steps: list[Step] = []
        while not self.accept_op("}"):
            if self.peek().kind == "eof":
                raise VrlCompileError("vrl: unterminated block")
            steps.extend(self._statement(env, cond_slot))
        return steps

    # -- expressions -------------------------------------------------------

    def _expr(self, env) -> ast.Expr:
        return self._coalesce(env)

    def _coalesce(self, env) -> ast.Expr:
        left = self._or(env)
        while self.accept_op("??"):
            left = ast.Func("coalesce", (left, self._or(env)))
        return left

    def _or(self, env) -> ast.Expr:
        left = self._and(env)
        while self.accept_op("||"):
            left = ast.Binary("or", left, self._and(env))
        return left

    def _and(self, env) -> ast.Expr:
        left = self._not(env)
        while self.accept_op("&&"):
            left = ast.Binary("and", left, self._not(env))
        return left

    def _not(self, env) -> ast.Expr:
        if self.accept_op("!"):
            return ast.Unary("not", self._not(env))
        return self._comparison(env)

    def _comparison(self, env) -> ast.Expr:
        left = self._additive(env)
        t = self.peek()
        if t.kind == "op" and t.value in ("==", "!=", "<", "<=", ">", ">="):
            self.next()
            op = "=" if t.value == "==" else t.value
            return ast.Binary(op, left, self._additive(env))
        return left

    def _additive(self, env) -> ast.Expr:
        left = self._mult(env)
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-"):
                self.next()
                left = ast.Binary(t.value, left, self._mult(env))
            else:
                return left

    def _mult(self, env) -> ast.Expr:
        left = self._unary(env)
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.next()
                left = ast.Binary(t.value, left, self._unary(env))
            else:
                return left

    def _unary(self, env) -> ast.Expr:
        if self.accept_op("-"):
            e = self._unary(env)
            if isinstance(e, ast.Literal) and isinstance(e.value, (int, float)):
                return ast.Literal(-e.value)
            return ast.Unary("-", e)
        return self._primary(env)

    def _primary(self, env) -> ast.Expr:
        """An atom plus any postfix ``[i]`` list indexing (VRL's array
        access; 0-based, negative from the end, out-of-range -> null)."""
        e = self._atom(env)
        while self.accept_op("["):
            neg = self.accept_op("-") is not None
            t = self.next()
            if t.kind != "number" or "." in t.value:
                raise VrlCompileError(
                    f"vrl: list index must be an integer literal at {t.pos}")
            self.expect_op("]")
            idx = -int(t.value) if neg else int(t.value)
            e = ast.Func("list_get", (e, ast.Literal(idx)))
        return e

    def _atom(self, env) -> ast.Expr:
        t = self.next()
        if t.kind == "number":
            return ast.Literal(float(t.value) if "." in t.value else int(t.value))
        if t.kind == "string":
            return ast.Literal(_unquote(t.value))
        if t.kind == "regex":
            return ast.Literal(t.value[2:-1])  # r'...' -> pattern text
        if t.kind == "path":
            if t.value == ".":
                raise VrlCompileError(
                    "vrl: whole-event '.' is only meaningful row-wise; "
                    "reference a field like .message")
            return ast.Column(t.value[1:])
        if t.kind == "ident":
            name = t.value
            if name in ("true", "false"):
                return ast.Literal(name == "true")
            if name == "null":
                return ast.Literal(None)
            if name == "if":
                return self._if_expression(env)
            if self.peek(skip_nl=False).kind == "op" and self.peek(skip_nl=False).value == "(":
                return self._call(name, env)
            if name.rstrip("!") in env:
                return env[name.rstrip("!")]
            raise VrlCompileError(
                f"vrl: unknown identifier {name!r} at {t.pos} "
                "(fields are referenced as .name)")
        if t.kind == "op" and t.value == "(":
            e = self._expr(env)
            self.expect_op(")")
            return e
        raise VrlCompileError(f"vrl: unexpected token {t.value!r} at {t.pos}")

    def _if_expression(self, env) -> ast.Expr:
        """``if cond { a } else { b }`` as a value -> CASE WHEN."""
        cond = self._expr(env)
        self.expect_op("{")
        then_v = self._expr(env)
        self.expect_op("}")
        otherwise = None
        if self.peek().kind == "ident" and self.peek().value == "else":
            self.next()
            if self.peek().kind == "ident" and self.peek().value == "if":
                self.next()
                otherwise = self._if_expression(env)
            else:
                self.expect_op("{")
                otherwise = self._expr(env)
                self.expect_op("}")
        return ast.Case(None, ((cond, then_v),), otherwise)

    def _call(self, name: str, env) -> ast.Expr:
        fallible = name.endswith("!")
        base = name.rstrip("!")
        self.expect_op("(")
        args: list[ast.Expr] = []
        named: dict[str, ast.Expr] = {}
        while not self.accept_op(")"):
            if args or named:
                self.expect_op(",")
            t = self.peek()
            save = self.i
            if t.kind == "ident":
                nm = self.next()
                if self.accept_op(":"):
                    named[nm.value] = self._expr(env)
                    continue
                self.i = save
            args.append(self._expr(env))
        return self._lower_call(base, args, named, fallible)

    def _lower_call(self, base: str, args: list[ast.Expr],
                    named: dict[str, ast.Expr], fallible: bool) -> ast.Expr:
        # named args map positionally for the functions that take them
        if base == "parse_timestamp" and "format" in named:
            args = args + [named.pop("format")]
        if base in ("replace", "round", "truncate", "slice") and named:
            for k in list(named):
                args.append(named.pop(k))
        if named:
            raise VrlCompileError(
                f"vrl: named arguments {sorted(named)} for {base}() not supported")

        if base in _OBJECT_FNS:
            return self._object_access(base, args)
        if base == "exists":
            if len(args) != 1:
                raise VrlCompileError("vrl: exists() takes one field")
            return ast.IsNull(args[0], negated=True)
        if base == "is_null":
            return ast.IsNull(args[0])
        if base == "contains":
            if len(args) != 2:
                raise VrlCompileError("vrl: contains(haystack, needle)")
            return ast.Binary(">", ast.Func("strpos", tuple(args)), ast.Literal(0))
        if base == "slice":
            # slice(x, start[, end]) 0-based half-open -> substr 1-based len
            if len(args) == 2:
                return ast.Func("substr", (args[0], ast.Binary("+", args[1], ast.Literal(1))))
            if len(args) == 3:
                return ast.Func("substr", (
                    args[0], ast.Binary("+", args[1], ast.Literal(1)),
                    ast.Binary("-", args[2], args[1])))
            raise VrlCompileError("vrl: slice(x, start[, end])")
        if base == "truncate":
            if len(args) != 2:
                raise VrlCompileError("vrl: truncate(x, limit)")
            return ast.Func("substr", (args[0], ast.Literal(1), args[1]))
        mapped = _FN.get(base)
        if mapped is None:
            hint = _UNSUPPORTED_HINTS.get(base)
            raise VrlCompileError(
                f"vrl: function {base!r} is not in the supported subset"
                + (f" ({hint})" if hint else "")
                + f"; supported: {', '.join(sorted(set(_FN) | _OBJECT_FNS | {'exists', 'is_null', 'contains', 'slice', 'truncate', 'del'}))}")
        return ast.Func(mapped, tuple(args))

    def _object_access(self, base: str, args: list[ast.Expr]) -> ast.Expr:
        """parse_json!(.m).a.b / parse_url!(.u).host / parse_regex!(..).name —
        the trailing path becomes the key/part/group argument."""
        t = self.peek(skip_nl=False)
        if not (t.kind == "path" and t.value != "."):
            raise VrlCompileError(
                f"vrl: {base}() yields an object; access a field from it "
                f"(e.g. {base}!(.x).field) — whole-object assignment has no "
                "columnar form")
        self.next(skip_nl=False)
        key = t.value[1:]
        if base == "parse_json":
            # dynamic variant: VRL values keep their JSON type; the SQL
            # json_get stays always-string for schema stability
            return ast.Func("json_get_dyn", (args[0], ast.Literal(key)))
        if base == "parse_url":
            return ast.Func("parse_url", (args[0], ast.Literal(key)))
        if base == "parse_key_value":
            return ast.Func("parse_key_value", (args[0], ast.Literal(key), *args[1:]))
        if base == "parse_syslog":
            return ast.Func("parse_syslog", (args[0], ast.Literal(key)))
        if base == "parse_regex":
            if len(args) != 2:
                raise VrlCompileError("vrl: parse_regex(x, r'pattern').group")
            return ast.Func("regex_extract", (args[0], args[1], ast.Literal(key)))
        raise VrlCompileError(f"vrl: unhandled object parser {base}")


def compile_vrl(statement: str) -> list[Step]:
    """VRL source -> vectorized step plan. Raises VrlCompileError outside the
    supported subset (build-time, like the reference's compile at vrl.rs:109)."""
    return _Parser(statement).parse_program()


def apply_vrl(batch: MessageBatch, steps: list[Step]) -> MessageBatch:
    """Run a compiled plan over one batch."""
    masks: dict[int, np.ndarray] = {}
    for step in steps:
        n = batch.num_rows
        ev = Evaluator.for_batch(batch)
        kind = step[0]
        if kind == "mask":
            _, slot, cond, parent = step
            c = _bool(ev.eval(cond), n)
            m = c.data.astype(bool) & c.mask()  # a null condition is false
            if parent is not None:
                m = m & masks[parent]
            masks[slot] = m
        elif kind == "maskelse":
            _, slot, then_slot, parent = step
            m = ~masks[then_slot]
            if parent is not None:
                m = m & masks[parent]
            masks[slot] = m
        elif kind == "assign":
            _, col, e = step
            batch = _set_column(batch, col, as_arr(ev.eval(e), n))
        elif kind == "cassign":
            _, col, slot, e = step
            val = as_arr(ev.eval(e), n)
            if batch.has_column(col):
                base = A.from_column(batch.column(col))
                if base.type != val.type:
                    if base.type == "null":
                        base = A.cast(base, val.type)
                    else:
                        val = A.cast(val, base.type)
            else:
                base = A.nulls(n, val.type)
            batch = _set_column(batch, col, A.if_else(Arr("bool", masks[slot]), val, base))
        elif kind == "expand":
            _, e = step
            batch = _expand_event(batch, as_arr(ev.eval(e), n))
        elif kind == "del":
            _, col = step
            if batch.has_column(col):
                batch = batch.drop_columns([col])
        elif kind == "filter":
            _, slot = step
            keep = np.zeros(n, bool) if slot is None else ~masks[slot]  # None: abort all
            batch = batch.filter(keep)
            # live masks must track the surviving rows
            masks = {k: m[keep] for k, m in masks.items()}
    hidden = [c for c in batch.column_names if c.startswith(_LOCAL_PREFIX)]
    return batch.drop_columns(hidden) if hidden else batch


def _expand_event(batch: MessageBatch, vals: Arr) -> MessageBatch:
    """``. = parse_json!(col)``: decode each row's JSON object into typed
    columns (the json codec's inference) and replace the event's data
    columns with them. ``__meta_*`` and hidden local columns survive. A row
    that is not exactly one JSON object becomes ``{}`` (``parse_json!`` is
    fallible per event)."""
    from arkflow_tpu_torch.plugins.codec.json_codec import JsonCodec

    payloads = []
    for pv in vals.to_pylist():
        if pv is None:
            payloads.append(b"{}")
        elif isinstance(pv, bytes):
            payloads.append(pv)
        else:
            payloads.append(str(pv).encode())
    codec = JsonCodec()
    try:
        decoded = codec.decode_many(payloads)
    except ArkError:
        fixed = []
        for p in payloads:
            try:
                ok = codec.decode(p).num_rows == 1
            except ArkError:
                ok = False
            fixed.append(p if ok else b"{}")
        try:
            decoded = codec.decode_many(fixed)
        except ArkError as e:
            raise ArkError(f"vrl: '. = parse_json!' failed to decode: {e}") from e
    if decoded.num_rows != batch.num_rows:
        raise ArkError(
            "vrl: '. = parse_json!' payloads must be one object per row "
            f"(got {decoded.num_rows} rows from {batch.num_rows})")
    cols = {c: batch.column(c) for c in batch.column_names
            if c.startswith("__meta_") or c.startswith(_LOCAL_PREFIX)}
    for c in decoded.column_names:
        if c not in cols:
            cols[c] = decoded.column(c)
    return MessageBatch(cols, batch.num_rows)


def _bool(v, n: int) -> Arr:
    return A.to_bool(as_arr(v, n))


def _set_column(batch: MessageBatch, col: str, arr: Arr) -> MessageBatch:
    return batch.with_column(col, A.to_column(arr))
