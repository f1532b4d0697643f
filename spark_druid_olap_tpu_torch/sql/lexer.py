"""SQL lexer (hand-rolled; no third-party parser deps in the image).

Port counterpart of ``spark_druid_olap_tpu/sql/lexer.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.

≈ the lexical layer of ``AbstractSparkSQLParser.scala`` (the reference uses
Scala parser combinators with a ``SqlLexical``)."""

from __future__ import annotations

import dataclasses
from typing import List


class SqlSyntaxError(Exception):
    pass


@dataclasses.dataclass(frozen=True)
class Token:
    kind: str       # 'ident' | 'number' | 'string' | 'op' | 'kw' | 'eof'
    value: str
    pos: int


KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "as", "and", "or", "not", "in", "between", "like", "is", "null",
    "case", "when", "then", "else", "end", "cast", "join", "inner", "left",
    "right", "outer", "cross", "on", "distinct", "exists", "asc", "desc",
    "interval", "date", "timestamp", "extract", "union", "all", "grouping",
    "sets", "cube", "rollup", "true", "false", "explain", "rewrite", "clear",
    "metadata", "execute", "query", "using", "datasource", "druiddatasource",
    "substring", "for", "approx", "with", "offset", "create", "drop",
    "refresh",
}

_TWO_CHAR_OPS = {"<=", ">=", "<>", "!=", "||"}
_ONE_CHAR_OPS = set("+-*/%(),.<>=")


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    i = 0
    n = len(sql)
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
                raise SqlSyntaxError(f"unterminated comment at {i}")
            i = j + 2
            continue
        if c == "'":
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == "'" and j + 1 < n and sql[j + 1] == "'":
                    buf.append("'")
                    j += 2
                elif sql[j] == "'":
                    break
                else:
                    buf.append(sql[j])
                    j += 1
            if j >= n:
                raise SqlSyntaxError(f"unterminated string at {i}")
            out.append(Token("string", "".join(buf), i))
            i = j + 1
            continue
        if c == '"' or c == "`":
            close = c
            j = sql.find(close, i + 1)
            if j < 0:
                raise SqlSyntaxError(f"unterminated quoted identifier at {i}")
            out.append(Token("ident", sql[i + 1: j], i))
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
            out.append(Token("number", sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j]
            kind = "kw" if word.lower() in KEYWORDS else "ident"
            out.append(Token(kind, word.lower() if kind == "kw" else word, i))
            i = j
            continue
        if sql[i:i + 2] in _TWO_CHAR_OPS:
            out.append(Token("op", sql[i:i + 2], i))
            i += 2
            continue
        if c in _ONE_CHAR_OPS:
            out.append(Token("op", c, i))
            i += 1
            continue
        if c == ";":
            i += 1
            continue
        raise SqlSyntaxError(f"unexpected character {c!r} at {i}")
    out.append(Token("eof", "", n))
    return out
