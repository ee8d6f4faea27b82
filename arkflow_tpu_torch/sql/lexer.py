"""SQL tokenizer.

Counterpart of ``arkflow_tpu/sql/lexer.py``, unchanged: pure Python."""

from __future__ import annotations

from dataclasses import dataclass

from arkflow_tpu_torch.errors import UnsupportedSql

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "offset", "as", "and", "or", "not", "in", "is", "null", "like", "ilike",
    "between", "case", "when", "then", "else", "end", "cast", "distinct",
    "asc", "desc", "join", "inner", "left", "right", "full", "outer", "cross",
    "on", "union", "all", "true", "false", "exists", "interval", "nulls",
    "first", "last", "with", "over", "partition",
}

_TWO_CHAR = {"<=", ">=", "!=", "<>", "||"}
_ONE_CHAR = set("+-*/%(),.=<>;")


@dataclass
class Token:
    kind: str  # kw | ident | number | string | op | eof
    value: str
    pos: int

    def is_kw(self, *names: str) -> bool:
        return self.kind == "kw" and self.value in names


def tokenize(sql: str) -> list[Token]:
    toks: list[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if sql.startswith("--", i):
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if sql.startswith("/*", i):
            j = sql.find("*/", i)
            if j < 0:
                raise UnsupportedSql(f"unterminated comment at {i}")
            i = j + 2
            continue
        if c == "'":
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":  # escaped ''
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            if j >= n:
                raise UnsupportedSql(f"unterminated string at {i}")
            toks.append(Token("string", "".join(buf), i))
            i = j + 1
            continue
        if c == '"' or c == "`":
            close = c
            j = sql.find(close, i + 1)
            if j < 0:
                raise UnsupportedSql(f"unterminated quoted identifier at {i}")
            toks.append(Token("ident", sql[i + 1:j], i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            seen_e = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_e:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_e and j > i:
                    seen_e = True
                    j += 1
                    if j < n and sql[j] in "+-":
                        j += 1
                else:
                    break
            toks.append(Token("number", sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j]
            low = word.lower()
            if low in KEYWORDS:
                toks.append(Token("kw", low, i))
            else:
                toks.append(Token("ident", word, i))
            i = j
            continue
        two = sql[i:i + 2]
        if two in _TWO_CHAR:
            toks.append(Token("op", two, i))
            i += 2
            continue
        if c in _ONE_CHAR:
            toks.append(Token("op", c, i))
            i += 1
            continue
        raise UnsupportedSql(f"unexpected character {c!r} at {i}")
    toks.append(Token("eof", "", n))
    return toks
