"""PQL parser — a hand-rolled recursive-descent/backtracking implementation of
the reference grammar pql/pql.peg (83 lines; the whole
language). The generated Go packrat parser (pql/pql.peg.go) is replaced by
direct descent with save/restore backtracking; semantics (arg assembly,
conditionals, duplicate-arg detection) mirror pql/ast.go's builder actions.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

from pilosa_tpu_torch.pql.ast import BETWEEN, Call, Condition, Query

_TIMESTAMP_RE = re.compile(r"\d{4}-[01]\d-[0-3]\dT\d\d:\d\d")
_IDENT_RE = re.compile(r"[A-Za-z][A-Za-z0-9]*")
_FIELD_RE = re.compile(r"[A-Za-z][A-Za-z0-9_-]*")
_BARE_STR_RE = re.compile(r"[A-Za-z0-9:_-]+")
_NUM_RE = re.compile(r"-?(\d+(\.\d*)?|\.\d+)")
_UINT_RE = re.compile(r"[1-9]\d*|0")
_COND_INT_RE = re.compile(r"-?[1-9]\d*|0")

RESERVED_FIELDS = ("_row", "_col", "_start", "_end", "_timestamp", "_field")

DUPLICATE_ARG_MSG = "duplicate argument provided"  # mirrors ast.go message


class ParseError(Exception):
    def __init__(self, msg: str, pos: int = 0, src: str = ""):
        self.pos = pos
        if src:
            line = src.count("\n", 0, pos) + 1
            col = pos - (src.rfind("\n", 0, pos) + 1) + 1
            msg = f"{msg} at line {line}, col {col}"
        super().__init__(msg)


class _Backtrack(Exception):
    """Internal: alternative failed; try the next one."""


class _Parser:
    def __init__(self, src: str):
        self.src = src
        self.pos = 0
        self.n = len(src)

    # -- low-level ---------------------------------------------------------

    def fail(self, msg: str = "syntax error"):
        raise _Backtrack(msg)

    def sp(self):
        while self.pos < self.n and self.src[self.pos] in " \t\n":
            self.pos += 1

    def lit(self, s: str) -> None:
        if not self.src.startswith(s, self.pos):
            self.fail(f"expected {s!r}")
        self.pos += len(s)

    def try_lit(self, s: str) -> bool:
        if self.src.startswith(s, self.pos):
            self.pos += len(s)
            return True
        return False

    def regex(self, rx: re.Pattern) -> str:
        m = rx.match(self.src, self.pos)
        if not m:
            self.fail(f"expected {rx.pattern}")
        self.pos = m.end()
        return m.group()

    def open_paren(self):
        self.lit("(")
        self.sp()

    def close_paren(self):
        self.lit(")")
        self.sp()

    def comma(self):
        self.sp()
        self.lit(",")
        self.sp()

    def try_comma(self) -> bool:
        save = self.pos
        self.sp()
        if self.try_lit(","):
            self.sp()
            return True
        self.pos = save
        return False

    def alt(self, *alternatives):
        """PEG ordered choice with backtracking."""
        for f in alternatives:
            save = self.pos
            try:
                return f()
            except _Backtrack:
                self.pos = save
        self.fail("no alternative matched")

    # -- grammar: Calls ----------------------------------------------------

    def parse_query(self) -> Query:
        q = Query()
        self.sp()
        while self.pos < self.n:
            q.calls.append(self.parse_call())
            self.sp()
        return q

    def parse_call(self) -> Call:
        for name, fn in (
            ("Set", self._special_set),
            ("SetRowAttrs", self._special_set_row_attrs),
            ("SetColumnAttrs", self._special_set_column_attrs),
            ("Clear", self._special_clear),
            ("ClearRow", self._special_clear_row),
            ("Store", self._special_store),
            ("TopN", self._special_posfield_call),
            ("Rows", self._special_posfield_call),
            ("Range", self._special_range),
        ):
            if self.src.startswith(name, self.pos):
                save = self.pos
                try:
                    return fn(name)
                except _Backtrack:
                    self.pos = save
        return self._generic_call()

    # Special forms. Note the PEG is ordered choice: 'Set' matches before
    # 'SetRowAttrs' never happens because peg tries alternatives in order and
    # 'Set' + open fails for 'SetRowAttrs(' (open expects '('); order here
    # tries the longest names first via exact startswith + backtracking.

    def _special_set(self, name: str) -> Call:
        # 'Set' open col comma args (comma timestamp)? close
        if self.src.startswith("SetRowAttrs", self.pos) or self.src.startswith(
            "SetColumnAttrs", self.pos
        ):
            self.fail("not plain Set")
        call = Call(name)
        self.lit("Set")
        self.open_paren()
        self._col(call)
        self.comma()
        self._args(call)
        save = self.pos
        try:
            self.comma()
            ts = self._timestampfmt()
            self._set_arg(call, "_timestamp", ts)
        except _Backtrack:
            self.pos = save
        self.close_paren()
        return call

    def _special_set_row_attrs(self, name: str) -> Call:
        # 'SetRowAttrs' open posfield comma row comma args close
        call = Call(name)
        self.lit("SetRowAttrs")
        self.open_paren()
        self._posfield(call)
        self.comma()
        self._row(call)
        self.comma()
        self._args(call)
        self.close_paren()
        return call

    def _special_set_column_attrs(self, name: str) -> Call:
        call = Call(name)
        self.lit("SetColumnAttrs")
        self.open_paren()
        self._col(call)
        self.comma()
        self._args(call)
        self.close_paren()
        return call

    def _special_clear(self, name: str) -> Call:
        if self.src.startswith("ClearRow", self.pos):
            self.fail("not plain Clear")
        call = Call(name)
        self.lit("Clear")
        self.open_paren()
        self._col(call)
        self.comma()
        self._args(call)
        self.close_paren()
        return call

    def _special_clear_row(self, name: str) -> Call:
        call = Call(name)
        self.lit("ClearRow")
        self.open_paren()
        self._arg(call)
        self.sp()
        self.close_paren()
        return call

    def _special_store(self, name: str) -> Call:
        call = Call(name)
        self.lit("Store")
        self.open_paren()
        call.children.append(self.parse_call())
        self.comma()
        self._arg(call)
        self.sp()
        self.close_paren()
        return call

    def _special_posfield_call(self, name: str) -> Call:
        # 'TopN'/'Rows' open posfield (comma allargs)? close
        call = Call(name)
        self.lit(name)
        self.open_paren()
        self._posfield(call)
        if self.try_comma():
            self._allargs(call)
        self.close_paren()
        return call

    def _special_range(self, name: str) -> Call:
        # 'Range' open field '=' value comma 'from='? ts comma 'to='? ts close
        call = Call(name)
        self.lit("Range")
        self.open_paren()
        fld = self.regex(_FIELD_RE)
        self.sp()
        self.lit("=")
        self.sp()
        self._set_arg(call, fld, self._value(call))
        self.comma()
        self.try_lit("from=")
        self._set_arg(call, "from", self._timestampfmt())
        self.comma()
        self.try_lit("to=")
        self.sp()
        self._set_arg(call, "to", self._timestampfmt())
        self.close_paren()
        return call

    def _generic_call(self) -> Call:
        name = self.regex(_IDENT_RE)
        call = Call(name)
        self.sp()
        self.open_paren()
        self._allargs(call)
        self.try_comma()
        self.close_paren()
        return call

    # -- grammar: args -----------------------------------------------------

    def _allargs(self, call: Call):
        # allargs <- Call (comma Call)* (comma args)? / args / sp
        # Alternatives mutate `call`; on backtrack the partial args/children
        # must be rolled back along with the position.
        def protected(f):
            def g():
                saved_args = dict(call.args)
                saved_children = list(call.children)
                try:
                    return f()
                except _Backtrack:
                    call.args.clear()
                    call.args.update(saved_args)
                    call.children[:] = saved_children
                    raise

            return g

        def calls_then_args():
            call.children.append(self.parse_call())
            while True:
                save = self.pos
                try:
                    self.comma()
                    call.children.append(self.parse_call())
                except _Backtrack:
                    self.pos = save
                    break
            save = self.pos
            try:
                self.comma()
                self._args(call)
            except _Backtrack:
                self.pos = save

        def just_args():
            self._args(call)

        def just_sp():
            self.sp()

        self.alt(protected(calls_then_args), protected(just_args), just_sp)

    def _args(self, call: Call):
        # args <- arg (comma args)? sp
        self._arg(call)
        save = self.pos
        try:
            self.comma()
            self._args(call)
        except _Backtrack:
            self.pos = save
        self.sp()

    def _arg(self, call: Call):
        # arg <- field '=' value / field COND value / conditional
        def eq_form():
            fld = self._field_name()
            self.sp()
            if not self.try_lit("="):
                self.fail("expected =")
            # '==' is a COND, not assignment
            if self.src.startswith("=", self.pos):
                self.fail("actually COND ==")
            self.sp()
            self._set_arg(call, fld, self._value(call))

        def cond_form():
            fld = self._field_name()
            self.sp()
            op = self._cond_op()
            self.sp()
            v = self._value(call)
            self._set_arg(call, fld, Condition(op, v))

        def conditional_form():
            self._conditional(call)

        self.alt(eq_form, cond_form, conditional_form)

    def _cond_op(self) -> str:
        for lit, op in (
            ("><", "><"),
            ("<=", "<="),
            (">=", ">="),
            ("==", "=="),
            ("!=", "!="),
            ("<", "<"),
            (">", ">"),
        ):
            if self.try_lit(lit):
                return op
        self.fail("expected condition operator")

    def _int64(self, v: str) -> int:
        """Parse an integer literal, rejecting values outside int64 (the
        reference's grammar does, pqlpeg_test.go ArgOutOfBounds)."""
        n = int(v)
        if not -(1 << 63) <= n < (1 << 63):
            raise ParseError(
                f"integer literal out of int64 range: {v}", self.pos, self.src
            )
        return n

    def _conditional(self, call: Call):
        # conditional <- condint condLT condfield condLT condint
        # e.g. `5 < f <= 10`
        low = self._int64(self.regex(_COND_INT_RE))
        self.sp()
        op1 = (
            "<=" if self.try_lit("<=")
            else ("<" if self.try_lit("<") else self.fail("expected <"))
        )
        self.sp()
        fld = self.regex(_FIELD_RE)
        self.sp()
        op2 = (
            "<=" if self.try_lit("<=")
            else ("<" if self.try_lit("<") else self.fail("expected <"))
        )
        self.sp()
        high = self._int64(self.regex(_COND_INT_RE))
        self.sp()
        # reference semantics (ast.go:82 endConditional): strict bounds are
        # shifted inward to produce an inclusive BETWEEN.
        if op1 == "<":
            low += 1
        if op2 == "<":
            high -= 1
        self._set_arg(call, fld, Condition(BETWEEN, [low, high]))

    def _field_name(self) -> str:
        for r in RESERVED_FIELDS:
            if self.src.startswith(r, self.pos):
                self.pos += len(r)
                return r
        return self.regex(_FIELD_RE)

    def _posfield(self, call: Call):
        self._set_arg(call, "_field", self.regex(_FIELD_RE))

    def _col(self, call: Call):
        self._pos_value(call, "_col")

    def _row(self, call: Call):
        self._pos_value(call, "_row")

    def _pos_value(self, call: Call, key: str):
        if self.try_lit("'"):
            s = self._quoted_string("'")
            self._set_arg(call, key, s)
        elif self.try_lit('"'):
            s = self._quoted_string('"')
            self._set_arg(call, key, s)
        else:
            self._set_arg(call, key, int(self.regex(_UINT_RE)))

    # -- grammar: values ---------------------------------------------------

    def _value(self, call: Call) -> Any:
        # value <- item / '[' list ']'
        self.sp()
        if self.try_lit("["):
            self.sp()
            items = [self._item(call)]
            while self.try_comma():
                items.append(self._item(call))
            self.sp()
            self.lit("]")
            self.sp()
            return items
        return self._item(call)

    def _item(self, call: Call) -> Any:
        # Ordered per pql.peg:43-53.
        s = self.src
        p = self.pos

        def keyword(word, pyval):
            def f():
                self.lit(word)
                # &(comma / sp close) lookahead
                save = self.pos
                self.sp()
                if self.pos < self.n and self.src[self.pos] in ",)]":
                    self.pos = save
                    return pyval
                self.fail("not a keyword")

            return f

        def timestamp():
            return self._timestampfmt()

        def number():
            v = self.regex(_NUM_RE)
            # must not be followed by ident chars (e.g. `123abc` is a bare string)
            if self.pos < self.n and (self.src[self.pos].isalnum() or self.src[self.pos] in ":_-"):
                self.fail("not a number")
            if "." in v:
                return float(v)
            # int args are int64 on the wire (pqlpeg ArgOutOfBounds)
            return self._int64(v)

        def nested_call():
            name = self.regex(_IDENT_RE)
            self.sp()
            self.open_paren()
            sub = Call(name)
            self._allargs(sub)
            self.try_comma()
            self.close_paren()
            return sub

        def bare_string():
            return self.regex(_BARE_STR_RE)

        def dquoted():
            self.lit('"')
            return self._quoted_string('"')

        def squoted():
            self.lit("'")
            return self._quoted_string("'")

        return self.alt(
            keyword("null", None),
            keyword("true", True),
            keyword("false", False),
            timestamp,
            number,
            nested_call,
            bare_string,
            dquoted,
            squoted,
        )

    def _timestampfmt(self) -> str:
        if self.try_lit('"'):
            ts = self.regex(_TIMESTAMP_RE)
            self.lit('"')
            return ts
        if self.try_lit("'"):
            ts = self.regex(_TIMESTAMP_RE)
            self.lit("'")
            return ts
        return self.regex(_TIMESTAMP_RE)

    def _quoted_string(self, quote: str) -> str:
        out = []
        while self.pos < self.n:
            ch = self.src[self.pos]
            if ch == "\\" and self.pos + 1 < self.n and self.src[self.pos + 1] in (quote, "\\"):
                out.append(self.src[self.pos + 1])
                self.pos += 2
                continue
            if ch == quote:
                self.pos += 1
                return "".join(out)
            out.append(ch)
            self.pos += 1
        self.fail("unterminated string")

    # -- arg assembly ------------------------------------------------------

    def _set_arg(self, call: Call, key: str, value: Any):
        if key in call.args:
            raise ParseError(f"{DUPLICATE_ARG_MSG}: {key}", self.pos, self.src)
        call.args[key] = value


def parse(src: str) -> Query:
    """Parse a PQL string into a Query (reference: pql.ParseString)."""
    p = _Parser(src)
    try:
        return p.parse_query()
    except _Backtrack as e:
        raise ParseError(str(e) or "syntax error", p.pos, src) from None
    except RecursionError:
        raise ParseError("query too deeply nested", p.pos, src) from None
