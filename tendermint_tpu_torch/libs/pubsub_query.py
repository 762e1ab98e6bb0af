"""Event query language (reference libs/pubsub/query/query.go + query.peg):

    tm.event = 'NewBlock' AND tx.height > 5 AND account.owner CONTAINS 'foo'

Conditions are AND-joined `key op operand`; ops: =, <, <=, >, >=,
CONTAINS, EXISTS.  Operands: single-quoted strings or numbers.  Matching is
over a {composite_key: [values...]} event attribute map — a query matches
when every condition is satisfied by at least one value.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

OPS = ("<=", ">=", "=", "<", ">", "CONTAINS", "EXISTS")

_TOKEN = re.compile(
    r"\s*(?:(?P<op><=|>=|=|<|>)|(?P<word>CONTAINS|EXISTS|AND)"
    r"|(?P<str>'[^']*')|(?P<num>-?\d+(?:\.\d+)?)"
    r"|(?P<key>[A-Za-z_][\w.\-]*))")


class QueryError(Exception):
    pass


@dataclass(frozen=True)
class Condition:
    key: str
    op: str
    operand: Optional[object]  # str | float | None (EXISTS)

    def match_values(self, values: Sequence[str]) -> bool:
        if self.op == "EXISTS":
            return len(values) > 0
        for v in values:
            if self.op == "CONTAINS":
                if isinstance(self.operand, str) and self.operand in v:
                    return True
                continue
            if isinstance(self.operand, float):
                try:
                    num = float(v)
                except ValueError:
                    continue
                if _cmp(num, self.op, self.operand):
                    return True
            else:
                if self.op == "=" and v == self.operand:
                    return True
        return False


def _cmp(a: float, op: str, b: float) -> bool:
    return {"=": a == b, "<": a < b, "<=": a <= b,
            ">": a > b, ">=": a >= b}[op]


class Query:
    def __init__(self, s: str):
        self.raw = s
        self.conditions: List[Condition] = _parse(s)

    def __repr__(self):
        return f"Query({self.raw!r})"

    def matches(self, events: Dict[str, List[str]]) -> bool:
        """events: composite key ('type.attr') -> list of values."""
        for c in self.conditions:
            if not c.match_values(events.get(c.key, ())):
                return False
        return True

    def condition_for(self, key: str) -> Optional[Condition]:
        for c in self.conditions:
            if c.key == key:
                return c
        return None


def _tokenize(s: str) -> List[Tuple[str, str]]:
    out, pos = [], 0
    while pos < len(s):
        m = _TOKEN.match(s, pos)
        if m is None or m.end() == pos:
            rest = s[pos:].strip()
            if not rest:
                break
            raise QueryError(f"cannot tokenize at {rest[:20]!r}")
        pos = m.end()
        for kind in ("op", "word", "str", "num", "key"):
            v = m.group(kind)
            if v is not None:
                out.append((kind, v))
                break
    return out


def _parse(s: str) -> List[Condition]:
    toks = _tokenize(s)
    if not toks:
        raise QueryError("empty query")
    conds = []
    i = 0
    while i < len(toks):
        kind, key = toks[i]
        if kind != "key":
            raise QueryError(f"expected key, got {key!r}")
        if i + 1 >= len(toks):
            raise QueryError(f"dangling key {key!r}")
        okind, op = toks[i + 1]
        if okind == "word" and op == "EXISTS":
            conds.append(Condition(key, "EXISTS", None))
            i += 2
        elif (okind == "op") or (okind == "word" and op == "CONTAINS"):
            if i + 2 >= len(toks):
                raise QueryError(f"missing operand after {op}")
            vkind, val = toks[i + 2]
            if vkind == "str":
                operand: object = val[1:-1]
            elif vkind == "num":
                operand = float(val)
            else:
                raise QueryError(f"bad operand {val!r}")
            if op == "CONTAINS" and not isinstance(operand, str):
                raise QueryError("CONTAINS needs a string operand")
            if op in ("<", "<=", ">", ">=") and not isinstance(operand,
                                                              float):
                raise QueryError(
                    f"{op} needs a numeric operand (string ordering is "
                    f"not supported)")
            conds.append(Condition(key, op, operand))
            i += 3
        else:
            raise QueryError(f"expected operator after {key!r}, got {op!r}")
        if i < len(toks):
            wkind, w = toks[i]
            if not (wkind == "word" and w == "AND"):
                raise QueryError(f"expected AND, got {w!r}")
            i += 1
    return conds
