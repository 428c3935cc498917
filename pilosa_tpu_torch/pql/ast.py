"""PQL abstract syntax tree.

Reference: pql/ast.go — Query{Calls}, Call{Name, Args,
Children}, Condition{Op, Value} (ast.go:27,263,482). Arg values are Python
ints/floats/bools/None/strings, nested Calls, lists, or Condition objects.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# Condition ops (reference: pql/token.go GT/LT/GTE/LTE/EQ/NEQ/BETWEEN).
GT = ">"
LT = "<"
GTE = ">="
LTE = "<="
EQ = "=="
NEQ = "!="
BETWEEN = "><"

# Args keys reserved by the grammar (pql.peg:60).
RESERVED = {"_row", "_col", "_start", "_end", "_timestamp", "_field"}


@dataclass
class Condition:
    op: str
    value: Any  # scalar, or [low, high] for BETWEEN

    def __repr__(self) -> str:
        return f"Condition({self.op!r}, {self.value!r})"

    def int_pair(self):
        if not isinstance(self.value, list) or len(self.value) != 2:
            raise ValueError(f"expected two-value condition, got {self.value!r}")
        return int(self.value[0]), int(self.value[1])


@dataclass
class Call:
    name: str
    args: Dict[str, Any] = field(default_factory=dict)
    children: List["Call"] = field(default_factory=list)

    # -- accessors (reference: ast.go:315-392) -----------------------------

    def arg(self, key: str, default=None):
        return self.args.get(key, default)

    def uint_arg(self, key: str) -> Optional[int]:
        v = self.args.get(key)
        if v is None:
            return None
        if isinstance(v, bool) or not isinstance(v, int):
            raise ValueError(f"argument {key!r} must be an unsigned integer, got {v!r}")
        if v < 0:
            raise ValueError(f"argument {key!r} must be >= 0, got {v}")
        return v

    def int_arg(self, key: str) -> Optional[int]:
        v = self.args.get(key)
        if v is None:
            return None
        if isinstance(v, bool) or not isinstance(v, int):
            raise ValueError(f"argument {key!r} must be an integer, got {v!r}")
        return v

    def bool_arg(self, key: str) -> Optional[bool]:
        v = self.args.get(key)
        if v is None:
            return None
        if not isinstance(v, bool):
            raise ValueError(f"argument {key!r} must be a bool, got {v!r}")
        return v

    def string_arg(self, key: str) -> Optional[str]:
        v = self.args.get(key)
        if v is None:
            return None
        if not isinstance(v, str):
            raise ValueError(f"argument {key!r} must be a string, got {v!r}")
        return v

    def call_arg(self, key: str) -> Optional["Call"]:
        v = self.args.get(key)
        if v is None:
            return None
        if not isinstance(v, Call):
            raise ValueError(f"argument {key!r} must be a call, got {v!r}")
        return v

    def field_arg(self) -> str:
        """The positional field name (grammar posfield -> args['_field'])."""
        v = self.args.get("_field")
        if not isinstance(v, str):
            raise ValueError(f"{self.name} requires a field argument")
        return v

    def has_conditions(self) -> bool:
        return any(isinstance(v, Condition) for v in self.args.values())

    def condition_args(self):
        return {k: v for k, v in self.args.items() if isinstance(v, Condition)}

    # -- serialization ------------------------------------------------------

    def __str__(self) -> str:
        parts: List[str] = [str(c) for c in self.children]
        for k in sorted(self.args, key=lambda k: (k not in RESERVED, k)):
            v = self.args[k]
            if isinstance(v, Condition):
                parts.append(f"{k} {v.op} {_fmt(v.value)}")
            else:
                parts.append(f"{k}={_fmt(v)}")
        return f"{self.name}({', '.join(parts)})"

    def __repr__(self) -> str:
        return f"Call({self!s})"


def _fmt(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, list):
        return "[" + ", ".join(_fmt(x) for x in v) + "]"
    if isinstance(v, str):
        return f'"{v}"'
    if isinstance(v, Call):
        return str(v)
    return str(v)


WRITE_CALLS = {"Set", "Clear", "SetRowAttrs", "SetColumnAttrs"}


@dataclass
class Query:
    calls: List[Call] = field(default_factory=list)

    def write_call_n(self) -> int:
        """Number of mutating calls (reference: ast.go WriteCallN)."""
        return sum(1 for c in self.calls if c.name in WRITE_CALLS)

    def __str__(self) -> str:
        return "\n".join(str(c) for c in self.calls)
