"""PQL abstract syntax tree.

Reference: pql/ast.go (Query, Call, typed args map, *Condition for BSI
comparisons). A parsed query is a list of top-level ``Call``s; each call
has a name, keyword args (typed: int, str, bool, list, Condition,
datetime), positional scalar args, and positional child calls.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

# Condition ops for BSI comparisons (reference: pql.Condition tokens)
COND_OPS = ("==", "!=", "<", "<=", ">", ">=", "between")


@dataclass
class Condition:
    """A BSI comparison: ``field <op> value`` or ``lo < field < hi``."""

    op: str
    value: Any  # int, or [lo, hi] for "between"

    def __post_init__(self) -> None:
        if self.op not in COND_OPS:
            raise ValueError(f"bad condition op {self.op!r}")


@dataclass
class Call:
    name: str
    args: dict[str, Any] = field(default_factory=dict)
    children: list["Call"] = field(default_factory=list)
    pos_args: list[Any] = field(default_factory=list)

    def arg(self, key: str, default: Any = None) -> Any:
        return self.args.get(key, default)

    def condition(self) -> tuple[str, Condition] | None:
        """The (field, Condition) pair if this call carries one."""
        for k, v in self.args.items():
            if isinstance(v, Condition):
                return k, v
        return None

    def field_arg(self) -> tuple[str, Any] | None:
        """First (field, row) style arg — the key that isn't a reserved
        option name (reference: Call.FieldArg)."""
        reserved = {"from", "to", "field", "_timestamp"}
        for k, v in self.args.items():
            if k not in reserved and not isinstance(v, Condition):
                return k, v
        return None

    def __repr__(self) -> str:
        parts = [repr(c) for c in self.children]
        parts += [f"{v!r}" for v in self.pos_args]
        parts += [f"{k}={v!r}" for k, v in self.args.items()]
        return f"{self.name}({', '.join(parts)})"

    def to_pql(self) -> str:
        """Render back to parseable PQL text (used to forward single calls
        to peer nodes — reference ships protobuf-serialized Calls instead)."""
        parts = [c.to_pql() for c in self.children]
        parts += [_render_value(v) for v in self.pos_args]
        for k, v in self.args.items():
            if isinstance(v, Condition):
                if v.op == "between":
                    lo, hi = v.value
                    parts.append(f"{_render_value(lo)} <= {k} <= {_render_value(hi)}")
                else:
                    parts.append(f"{k} {v.op} {_render_value(v.value)}")
            else:
                parts.append(f"{k}={_render_value(v)}")
        return f"{self.name}({', '.join(parts)})"


def _render_value(v: Any) -> str:
    from datetime import datetime

    if isinstance(v, Call):
        return v.to_pql()
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, datetime):
        return v.strftime("%Y-%m-%dT%H:%M:%S")
    if isinstance(v, str):
        escaped = v.replace("\\", "\\\\").replace('"', '\\"')
        return f'"{escaped}"'
    if isinstance(v, list):
        return "[" + ", ".join(_render_value(x) for x in v) + "]"
    return str(v)
