"""PQL parser: query text → list of Call ASTs.

Reference: pql/pql.peg (compiled by pigeon into pql.peg.go). The grammar is
small, so a hand-written tokenizer + recursive-descent parser replaces the
PEG machinery; semantics follow the reference grammar:

    query      := call*
    call       := Name '(' args? ')'
    args       := arg (',' arg)*
    arg        := call                      (positional child)
                | Name '=' value            (keyword arg)
                | Name '=' call             (call-valued keyword arg)
                | Name COND value           (BSI condition, e.g. f > 5)
                | value COND Name COND value (between, e.g. 1 < f < 10)
                | Name '><' '[' v ',' v ']' (legacy between)
                | value                     (positional scalar)
    value      := int | float | string | bool | null | timestamp | list

Both ``Row(f > 5)`` (v1.3+) and ``Range(f > 5)`` (older) comparison forms
are accepted; the executor treats them identically.
"""

from __future__ import annotations

import re
from datetime import datetime
from typing import Any

from pilosa_tpu_torch.pql.ast import Call, Condition

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<timestamp>\d{4}-\d{2}-\d{2}(?:T\d{2}:\d{2}(?::\d{2})?)?)
  | (?P<float>-?\d+\.\d+(?:[eE][+-]?\d+)?|-?\d+[eE][+-]?\d+)
  | (?P<int>-?\d+)
  | (?P<name>[A-Za-z_][A-Za-z0-9_-]*)
  | (?P<string>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<op><=|>=|==|!=|><|<|>|=)
  | (?P<punct>[(),\[\]])
    """,
    re.VERBOSE,
)

_BOOL_NULL = {"true": True, "false": False, "null": None}


class PQLError(ValueError):
    pass


class _Token:
    __slots__ = ("kind", "value", "pos")

    def __init__(self, kind: str, value: Any, pos: int):
        self.kind = kind
        self.value = value
        self.pos = pos

    def __repr__(self) -> str:
        return f"{self.kind}:{self.value!r}"


def _tokenize(text: str) -> list[_Token]:
    tokens = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise PQLError(f"unexpected character {text[pos]!r} at {pos}")
        kind = m.lastgroup
        val = m.group()
        if kind != "ws":
            if kind == "int":
                tokens.append(_Token("int", int(val), pos))
            elif kind == "float":
                tokens.append(_Token("float", float(val), pos))
            elif kind == "string":
                tokens.append(_Token("string", _unquote(val), pos))
            elif kind == "timestamp":
                tokens.append(_Token("timestamp", _parse_ts(val), pos))
            else:
                tokens.append(_Token(kind, val, pos))
        pos = m.end()
    tokens.append(_Token("eof", None, pos))
    return tokens


def _unquote(s: str) -> str:
    body = s[1:-1]
    return re.sub(r"\\(.)", r"\1", body)


def _parse_ts(s: str) -> datetime:
    for fmt in ("%Y-%m-%dT%H:%M:%S", "%Y-%m-%dT%H:%M", "%Y-%m-%d"):
        try:
            return datetime.strptime(s, fmt)
        except ValueError:
            continue
    raise PQLError(f"bad timestamp {s!r}")


def coerce_timestamp(value) -> datetime | None:
    """Accept a timestamp arg in any form PQL clients send it: already a
    datetime (bare literal), or a quoted ISO string (the reference's
    grammar allows both ``from=2006-01-02T15:04`` and
    ``from="2006-01-02T15:04"``). None / non-timestamp strings → None."""
    if isinstance(value, datetime):
        return value
    if isinstance(value, str):
        try:
            return _parse_ts(value)
        except PQLError:
            return None
    return None


_COND_FROM_OP = {"<": "<", "<=": "<=", ">": ">", ">=": ">=", "==": "==", "!=": "!="}
# flip for the "value OP name" between-prefix form: 5 < f  means  f > 5
_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}


class _Parser:
    def __init__(self, tokens: list[_Token]):
        self.tokens = tokens
        self.i = 0

    def peek(self, k: int = 0) -> _Token:
        return self.tokens[min(self.i + k, len(self.tokens) - 1)]

    def next(self) -> _Token:
        t = self.tokens[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def expect(self, kind: str, value: Any = None) -> _Token:
        t = self.next()
        if t.kind != kind or (value is not None and t.value != value):
            raise PQLError(
                f"expected {value or kind} at {t.pos}, got {t.value!r}"
            )
        return t

    # ------------------------------------------------------------- grammar
    def parse_query(self) -> list[Call]:
        calls = []
        while self.peek().kind != "eof":
            calls.append(self.parse_call())
        return calls

    def parse_call(self) -> Call:
        name = self.expect("name").value
        self.expect("punct", "(")
        call = Call(name)
        while True:
            t = self.peek()
            if t.kind == "punct" and t.value == ")":
                self.next()
                break
            self.parse_arg(call)
            t = self.peek()
            if t.kind == "punct" and t.value == ",":
                self.next()
            elif not (t.kind == "punct" and t.value == ")"):
                raise PQLError(f"expected ',' or ')' at {t.pos}, got {t.value!r}")
        return call

    def parse_arg(self, call: Call) -> None:
        t = self.peek()
        # positional child call:  Name '('
        if t.kind == "name" and self.peek(1).kind == "punct" and self.peek(1).value == "(":
            child_or_kw = self.parse_call()
            call.children.append(child_or_kw)
            return
        if t.kind == "name" and self.peek(1).kind == "op":
            name = self.next().value
            op = self.next().value
            if op == "=":
                self.parse_keyword_value(call, name)
            elif op == "><":
                # legacy between: f >< [lo, hi]
                vals = self.parse_value()
                if not isinstance(vals, list) or len(vals) != 2:
                    raise PQLError(f"'><' needs a two-element list at {t.pos}")
                call.args[name] = Condition("between", vals)
            else:
                call.args[name] = Condition(_COND_FROM_OP[op], self.parse_value())
            return
        # between prefix form:  value < name < value  (integers only —
        # BSI conditions are integer comparisons)
        if t.kind == "timestamp" and self.peek(1).kind == "op":
            raise PQLError(f"timestamps are not valid in conditions at {t.pos}")
        if t.kind in ("int", "float") and self.peek(1).kind == "op":
            lo = self.next().value
            op1 = self.next().value
            if self.peek().kind != "name":
                raise PQLError(f"expected field name at {self.peek().pos}")
            name = self.next().value
            op2t = self.next()
            if op2t.kind != "op" or op2t.value not in ("<", "<="):
                raise PQLError(f"bad between syntax at {op2t.pos}")
            hi = self.parse_value()
            if op1 not in ("<", "<="):
                raise PQLError(f"bad between syntax at {t.pos}")
            lo_adj = lo if op1 == "<=" else lo + 1
            hi_adj = hi if op2t.value == "<=" else hi - 1
            call.args[name] = Condition("between", [lo_adj, hi_adj])
            return
        # positional scalar
        call.pos_args.append(self.parse_value())

    def parse_keyword_value(self, call: Call, name: str) -> None:
        t = self.peek()
        if t.kind == "name" and t.value not in _BOOL_NULL:
            if self.peek(1).kind == "punct" and self.peek(1).value == "(":
                call.args[name] = self.parse_call()  # call-valued kwarg
                return
            # bare identifier value (e.g. field=fieldname)
            call.args[name] = self.next().value
            return
        call.args[name] = self.parse_value()

    def parse_value(self) -> Any:
        t = self.next()
        if t.kind in ("int", "float", "string", "timestamp"):
            return t.value
        if t.kind == "name":
            if t.value in _BOOL_NULL:
                return _BOOL_NULL[t.value]
            return t.value
        if t.kind == "punct" and t.value == "[":
            out = []
            while True:
                if self.peek().kind == "punct" and self.peek().value == "]":
                    self.next()
                    return out
                out.append(self.parse_value())
                if self.peek().kind == "punct" and self.peek().value == ",":
                    self.next()
        raise PQLError(f"unexpected token {t.value!r} at {t.pos}")


def parse(text: str) -> list[Call]:
    """Parse PQL text into a list of top-level calls (reference:
    pql.ParseString)."""
    return _Parser(_tokenize(text)).parse_query()
