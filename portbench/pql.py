"""A small parser of the PQL that the traffic mixes send, for the
reference and the byte counts; it shares no code with the program.

    Count(Intersect(Row(f=1), Union(Row(f=2), Row(f=3))))
    TopN(f, Row(f=1), n=5)            TopN(f, Xor(...), ids=[1, 4, 6])
    Row(-500 <= total_amount <= 2000) Row(total_amount > 10)
    GroupBy(Rows(a), Rows(b), filter=Row(...), aggregate=Sum(field=v))
    Sum(Row(...), field=v)            Min(field=v)   Max(...)

A call is ``Call(name, children, args, fields)``: ``children`` its
positional calls, ``args`` its keyword arguments, ``fields`` its bare
positional names (TopN's and Rows' field). A condition on an int field
becomes the argument ``{field: (op, value)}``, or ``(\"between\", lo,
hi, lo_inclusive, hi_inclusive)``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

_TOKEN = re.compile(r"\s*(?:(<=|>=|==|!=|<|>)|(-?\d+)|([A-Za-z_][A-Za-z0-9_.-]*)|(.))")


@dataclass
class Call:
    name: str
    children: list = field(default_factory=list)
    args: dict = field(default_factory=dict)
    fields: list = field(default_factory=list)


def tokens(text: str) -> list:
    out = []
    for m in _TOKEN.finditer(text):
        op, num, ident, punct = m.groups()
        if op:
            out.append(("op", op))
        elif num:
            out.append(("int", int(num)))
        elif ident:
            out.append(("id", ident))
        elif punct and not punct.isspace():
            out.append(("p", punct))
    return out


class _Parser:
    def __init__(self, text: str):
        self.toks = tokens(text)
        self.i = 0

    def peek(self, k: int = 0):
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else ("end", None)

    def take(self, kind: str, value=None):
        tok = self.peek()
        if tok[0] != kind or (value is not None and tok[1] != value):
            raise ValueError(f"PQL: expected {value or kind} at token {self.i}, got {tok}")
        self.i += 1
        return tok[1]

    def call(self) -> Call:
        name = self.take("id")
        self.take("p", "(")
        c = Call(name)
        while self.peek() != ("p", ")"):
            self.arg(c)
            if self.peek() == ("p", ","):
                self.i += 1
        self.take("p", ")")
        return c

    def value(self):
        kind, v = self.peek()
        if kind == "int":
            self.i += 1
            return v
        if kind == "p" and v == "[":
            self.i += 1
            items = []
            while self.peek() != ("p", "]"):
                items.append(self.value())
                if self.peek() == ("p", ","):
                    self.i += 1
            self.take("p", "]")
            return items
        if kind == "id" and self.peek(1) == ("p", "("):
            return self.call()
        if kind == "id":
            self.i += 1
            return v
        raise ValueError(f"PQL: unexpected {self.peek()}")

    def arg(self, c: Call) -> None:
        kind, v = self.peek()
        nxt = self.peek(1)
        if kind == "id" and nxt == ("p", "("):
            c.children.append(self.call())
        elif kind == "id" and nxt == ("p", "="):
            self.i += 2
            c.args[v] = self.value()
        elif kind == "id" and nxt[0] == "op":
            self.i += 2
            c.args[v] = (_OPS[nxt[1]], self.cond_value())
        elif kind == "int" and nxt[0] == "op":
            lo = v
            lo_op = nxt[1]
            self.i += 2
            name = self.take("id")
            hi_op = self.take("op")
            hi = self.take("int")
            if lo_op not in ("<", "<=") or hi_op not in ("<", "<="):
                raise ValueError("PQL: a range is lo < field < hi, with < or <=")
            c.args[name] = ("between", lo, hi, lo_op == "<=", hi_op == "<=")
        elif kind == "id":
            self.i += 1
            c.fields.append(v)
        else:
            raise ValueError(f"PQL: unexpected {self.peek()}")

    def cond_value(self):
        kind, v = self.peek()
        if kind == "int":
            self.i += 1
            return v
        if kind == "id" and v == "null":
            self.i += 1
            return None
        raise ValueError(f"PQL: a condition compares with an integer or null, not {v!r}")


_OPS = {"<": "lt", "<=": "le", ">": "gt", ">=": "ge", "==": "eq", "!=": "ne"}


def parse(text: str) -> list[Call]:
    """Every top-level call of ``text``."""
    p = _Parser(text)
    calls = []
    while p.peek()[0] != "end":
        calls.append(p.call())
    return calls


def row_leaves(c: Call) -> list[tuple]:
    """The distinct (field, row or condition) leaves of a bitmap tree,
    in order of first appearance."""
    out: list[tuple] = []

    def walk(x: Call) -> None:
        if x.name == "Row":
            for k, v in x.args.items():
                leaf = (k, v)
                if leaf not in out:
                    out.append(leaf)
        for ch in x.children:
            walk(ch)

    walk(c)
    return out
