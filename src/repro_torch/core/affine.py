"""Tiny affine-expression parser.

Parses strings like ``"2*i + j - N + 3"`` into {symbol: Fraction} maps
(the constant term is stored under key ``1``). Used for loop bounds,
array subscripts and the paper's custom-constraint interface
(Section III-A2: ``S0_it_1 - x >= 0`` etc.).

Grammar (recursive descent):
  expr   := term (('+'|'-') term)*
  term   := factor ('*' factor)*
  factor := INT | NAME | '-' factor | '(' expr ')'
Products must stay affine: at most one non-constant factor per term.
"""
from __future__ import annotations

import re
from fractions import Fraction
from typing import Dict, Union

Affine = Dict[Union[str, int], Fraction]  # {name: coeff, 1: const}

_TOKEN = re.compile(r"\s*(?:(\d+)|([A-Za-z_][A-Za-z_0-9]*)|(.))")


class _Parser:
    def __init__(self, text: str):
        self.toks = []
        for m in _TOKEN.finditer(text):
            if m.group(1):
                self.toks.append(("int", int(m.group(1))))
            elif m.group(2):
                self.toks.append(("name", m.group(2)))
            elif m.group(3).strip():
                self.toks.append(("op", m.group(3)))
        self.pos = 0

    def peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        self.pos += 1
        return t

    def parse(self) -> Affine:
        e = self.expr()
        if self.pos != len(self.toks):
            raise ValueError(f"trailing tokens at {self.pos}: {self.toks[self.pos:]}")
        return e

    def expr(self) -> Affine:
        out = self.term()
        while True:
            kind, val = self.peek()
            if kind == "op" and val in "+-":
                self.next()
                rhs = self.term()
                sign = 1 if val == "+" else -1
                for k, v in rhs.items():
                    out[k] = out.get(k, Fraction(0)) + sign * v
            else:
                return out

    def term(self) -> Affine:
        out = self.factor()
        while True:
            kind, val = self.peek()
            if kind == "op" and val == "*":
                self.next()
                rhs = self.factor()
                out = _affine_mul(out, rhs)
            elif kind == "op" and val == "/":
                self.next()
                rhs = self.factor()
                if set(rhs) - {1}:
                    raise ValueError("non-constant divisor in affine expr")
                out = {k: v / rhs.get(1, Fraction(0)) for k, v in out.items()}
            else:
                return out

    def factor(self) -> Affine:
        kind, val = self.next()
        if kind == "int":
            return {1: Fraction(val)}
        if kind == "name":
            return {val: Fraction(1)}
        if kind == "op" and val == "-":
            f = self.factor()
            return {k: -v for k, v in f.items()}
        if kind == "op" and val == "+":
            return self.factor()
        if kind == "op" and val == "(":
            e = self.expr()
            k2, v2 = self.next()
            if (k2, v2) != ("op", ")"):
                raise ValueError("expected ')'")
            return e
        raise ValueError(f"unexpected token {kind} {val}")


def _affine_mul(a: Affine, b: Affine) -> Affine:
    a_syms = set(a) - {1}
    b_syms = set(b) - {1}
    if a_syms and b_syms:
        raise ValueError("non-affine product")
    if b_syms:
        a, b = b, a
    c = b.get(1, Fraction(0))
    return {k: v * c for k, v in a.items()}


def parse_affine(text: str) -> Affine:
    """Parse an affine expression string into {symbol: coeff, 1: const}."""
    out = _Parser(str(text)).parse()
    return {k: v for k, v in out.items() if v != 0} or {1: Fraction(0)}


def affine_add(a: Affine, b: Affine, bsign: int = 1) -> Affine:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, Fraction(0)) + bsign * v
    return {k: v for k, v in out.items() if v != 0}


def affine_sub(a: Affine, b: Affine) -> Affine:
    return affine_add(a, b, -1)


def affine_scale(a: Affine, c) -> Affine:
    c = Fraction(c)
    return {k: v * c for k, v in a.items() if v * c != 0}


def affine_eval(a: Affine, env: Dict[str, Fraction]) -> Fraction:
    tot = Fraction(0)
    for k, v in a.items():
        if k == 1:
            tot += v
        else:
            tot += v * Fraction(env[k])
    return tot


def affine_to_str(a: Affine, order=None) -> str:
    if not a:
        return "0"
    keys = [k for k in (order or sorted(a, key=str)) if k in a and a[k] != 0]
    parts = []
    for k in keys:
        v = a[k]
        if k == 1:
            parts.append(f"{v}")
        elif v == 1:
            parts.append(f"{k}")
        elif v == -1:
            parts.append(f"-{k}")
        else:
            parts.append(f"{v}*{k}")
    s = " + ".join(parts).replace("+ -", "- ")
    return s or "0"


_COMPARE = re.compile(r"(.*?)(<=|>=|==|=|<|>)(.*)")


def parse_constraint(text: str):
    """Parse ``lhs (<=|>=|==|<|>) rhs`` into (affine, kind) with kind in
    {'>=0', '==0'} after normalization to ``affine {>=,==} 0``.

    Strict inequalities are integerized: a > b  →  a - b - 1 >= 0.
    """
    m = _COMPARE.match(text)
    if not m:
        raise ValueError(f"not a constraint: {text!r}")
    lhs, op, rhs = m.group(1), m.group(2), m.group(3)
    diff = affine_sub(parse_affine(lhs), parse_affine(rhs))
    if op in ("==", "="):
        return diff, "==0"
    if op == ">=":
        return diff, ">=0"
    if op == "<=":
        return {k: -v for k, v in diff.items()}, ">=0"
    if op == ">":
        d = dict(diff)
        d[1] = d.get(1, Fraction(0)) - 1
        return d, ">=0"
    if op == "<":
        d = {k: -v for k, v in diff.items()}
        d[1] = d.get(1, Fraction(0)) - 1
        return d, ">=0"
    raise ValueError(op)
