"""Mask op-code expression parser — parity with the reference's nom parser
(`GaussianSplattingMaskOp::parse`, `src/app.rs:1660-1783`). Pure Python, a
copy of `wgpu_3dgs_viewer_app_tpu.mask.expr` (same trees, same errors).

Grammar (loosest to tightest, all left-associative):
    union        := intersection ("|" intersection)*
    intersection := difference  ("&" difference)*
    difference   := symdiff     ("-" symdiff)*
    symdiff      := factor      ("^" factor)*
    factor       := shape-index | "(" union ")" | "!" factor
i.e. precedence `!` > `^` > `-` > `&` > `|`, shapes are decimal indices.
Empty input parses to None (no mask op; ref `src/app.rs:1774-1776`).

Also: `validate_shapes` (ref `src/app.rs:1785-1813`) and lowering to an
evaluatable tree (`to_tree`, ref `src/app.rs:1815-1837`).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional


class MaskParseError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class MaskOp:
    """Syntax tree node. Mirror of `GaussianSplattingMaskOp` (`src/app.rs:1617-1658`)."""

    kind: str  # union | intersection | difference | symmetric_difference | complement | shape
    left: Optional["MaskOp"] = None
    right: Optional["MaskOp"] = None
    index: Optional[int] = None

    @staticmethod
    def shape(i: int) -> "MaskOp":
        return MaskOp("shape", index=i)

    def validate_shapes(self, shape_count: int) -> None:
        """Raises MaskParseError naming the first out-of-range index
        (ref `validate_shapes`, `src/app.rs:1785-1813`)."""
        if self.kind == "shape":
            if self.index >= shape_count:
                raise MaskParseError(f"shape index {self.index} out of range")
            return
        if self.left is not None:
            self.left.validate_shapes(shape_count)
        if self.right is not None:
            self.right.validate_shapes(shape_count)

    def __str__(self) -> str:
        sym = {
            "union": "|",
            "intersection": "&",
            "difference": "-",
            "symmetric_difference": "^",
        }
        if self.kind == "shape":
            return str(self.index)
        if self.kind == "complement":
            return f"!({self.left})"
        return f"({self.left} {sym[self.kind]} {self.right})"


_TOKEN_RE = re.compile(r"\s*(\d+|[()!^\-&|])")


def _tokenize(src: str) -> list:
    out = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            if src[pos:].strip() == "":
                break
            raise MaskParseError(
                f"Failed to parse mask operation: unexpected character {src[pos:].strip()[0]!r}"
            )
        out.append(m.group(1))
        pos = m.end()
    return out


class _Parser:
    def __init__(self, tokens: list):
        self.toks = tokens
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        t = self.peek()
        if t is None:
            raise MaskParseError("Failed to parse mask operation: unexpected end of input")
        self.i += 1
        return t

    def _binary(self, sub, ops: dict) -> MaskOp:
        node = sub()
        while self.peek() in ops:
            op = self.next()
            node = MaskOp(ops[op], left=node, right=sub())
        return node

    def union(self) -> MaskOp:
        return self._binary(self.intersection, {"|": "union"})

    def intersection(self) -> MaskOp:
        return self._binary(self.difference, {"&": "intersection"})

    def difference(self) -> MaskOp:
        return self._binary(self.symdiff, {"-": "difference"})

    def symdiff(self) -> MaskOp:
        return self._binary(self.factor, {"^": "symmetric_difference"})

    def factor(self) -> MaskOp:
        t = self.next()
        if t == "!":
            return MaskOp("complement", left=self.factor())
        if t == "(":
            node = self.union()
            if self.next() != ")":
                raise MaskParseError("Failed to parse mask operation: expected ')'")
            return node
        if t.isdigit():
            return MaskOp.shape(int(t))
        raise MaskParseError(f"Failed to parse mask operation: unexpected token {t!r}")


def parse(source: str) -> Optional[MaskOp]:
    """Parse op-code; empty/whitespace -> None (ref `src/app.rs:1774-1783`)."""
    src = source.strip()
    if not src:
        return None
    p = _Parser(_tokenize(src))
    node = p.union()
    if p.peek() is not None:
        raise MaskParseError(
            f"Failed to parse mask operation: trailing input {p.peek()!r}"
        )
    return node
