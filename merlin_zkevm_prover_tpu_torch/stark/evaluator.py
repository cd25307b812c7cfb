"""Vectorized step-program evaluator.

The counterpart of the reference's generated constraint-evaluation code
(chelpers): where the reference interprets an op/args bytecode over
AVX2-batched row blocks, this evaluator walks the step program's expression
trees with hash-consed memoization and runs one whole-domain tensor op per
node.  Rows are the data-parallel axis; rotations become `torch.roll`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import torch

from ..ops import goldilocks as gl
from ..ops import goldilocks3 as gl3
from ..ops.goldilocks import GL
from ..ops.goldilocks3 import GL3
from .air import Expr
from .compiler import StarkInfo

Value = Union[GL, GL3]


def _is3(v: Value) -> bool:
    return isinstance(v, GL3)


def _add(a: Value, b: Value) -> Value:
    if _is3(a) and _is3(b):
        return gl3.add(a, b)
    if _is3(a):
        return GL3(gl.add(a.c0, b), a.c1, a.c2)
    if _is3(b):
        return GL3(gl.add(b.c0, a), b.c1, b.c2)
    return gl.add(a, b)


def _sub(a: Value, b: Value) -> Value:
    if _is3(a) and _is3(b):
        return gl3.sub(a, b)
    if _is3(a):
        return GL3(gl.sub(a.c0, b), a.c1, a.c2)
    if _is3(b):
        return GL3(gl.sub(a, b.c0), gl.neg(b.c1), gl.neg(b.c2))
    return gl.sub(a, b)


def _mul(a: Value, b: Value) -> Value:
    if _is3(a) and _is3(b):
        return gl3.mul(a, b)
    if _is3(a):
        return gl3.mul_base(a, b)
    if _is3(b):
        return gl3.mul_base(b, a)
    return gl.mul(a, b)


def _neg(a: Value) -> Value:
    if _is3(a):
        return gl3.neg(a)
    return gl.neg(a)


def roll_gl(a: GL, k: int) -> GL:
    if k == 0:
        return a
    return torch.roll(a, -k, dims=0)


@dataclass
class EvalContext:
    """All operand sources for one step-program evaluation."""

    info: StarkInfo
    domain: str                       # 'n' or 'ext'
    sections: Dict[str, GL]           # section name -> (rows, width) GL
    const: GL                         # (rows, nConstants) on this domain
    challenges: Optional[GL3] = None  # (8,) GL3
    publics: Optional[GL] = None      # (nPublics,) GL
    evals: Optional[GL3] = None       # (size_eval,) GL3
    x: Optional[GL] = None            # (rows,)
    zi: Optional[GL] = None           # (rows,) ext only
    x_div_x_sub_xi: Optional[GL3] = None
    x_div_x_sub_wxi: Optional[GL3] = None
    exp_pols: Dict[int, Value] = field(default_factory=dict)
    # cm columns computed earlier in the SAME step program (e.g. the
    # compiler's chained connection im pols reference previous cm3 ims
    # before the section matrix exists)
    pending_cm: Dict[int, Value] = field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return self.const.device

    @property
    def roll_k(self) -> int:
        return 1 if self.domain == "n" else (1 << self.info.blowup_bits)

    def cm_value(self, pid: int, prime: bool) -> Value:
        pm = self.info.cm_pols[pid]
        if pid in self.pending_cm:
            v = self.pending_cm[pid]
            if prime:
                k = self.roll_k
                if isinstance(v, GL3):
                    return GL3(roll_gl(v.c0, k), roll_gl(v.c1, k),
                               roll_gl(v.c2, k))
                return roll_gl(v, k)
            return v
        section = pm.section
        if self.domain == "ext" and section != "cm4_2ns":
            section = section.replace("_n", "_2ns")
        mat = self.sections[section]
        pos = pm.section_pos
        if pm.dim == 1:
            v: Value = mat[:, pos]
        else:
            v = GL3(mat[:, pos], mat[:, pos + 1], mat[:, pos + 2])
        if prime:
            k = self.roll_k
            if pm.dim == 1:
                v = roll_gl(v, k)
            else:
                v = GL3(roll_gl(v.c0, k), roll_gl(v.c1, k), roll_gl(v.c2, k))
        return v

    def const_value(self, cid: int, prime: bool) -> GL:
        v = self.const[:, cid]
        if prime:
            v = roll_gl(v, self.roll_k)
        return v


def eval_expr(e: Expr, ctx: EvalContext, memo: Dict[Expr, Value]) -> Value:
    hit = memo.get(e)
    if hit is not None:
        return hit
    k = e.kind
    if k == "cm":
        v: Value = ctx.cm_value(e.id, e.prime)
    elif k == "const":
        v = ctx.const_value(e.id, e.prime)
    elif k == "challenge":
        v = ctx.challenges[e.id]
    elif k == "public":
        v = ctx.publics[e.id]
    elif k == "number":
        v = gl.const(e.value, device=ctx.device)
    elif k == "x":
        v = ctx.x
    elif k == "Zi":
        v = ctx.zi
    elif k == "eval":
        v = ctx.evals[e.id]
    elif k == "xDivXSubXi":
        v = ctx.x_div_x_sub_xi
    elif k == "xDivXSubWXi":
        v = ctx.x_div_x_sub_wxi
    elif k == "q":
        # q chunk pid: stored in cm4_2ns via its cm pol
        v = ctx.cm_value(ctx.info.qs[e.id], e.prime)
    elif k == "tmpexp":
        v = ctx.exp_pols[e.id]
    elif k == "add":
        v = _add(eval_expr(e.args[0], ctx, memo), eval_expr(e.args[1], ctx, memo))
    elif k == "sub":
        v = _sub(eval_expr(e.args[0], ctx, memo), eval_expr(e.args[1], ctx, memo))
    elif k == "mul":
        v = _mul(eval_expr(e.args[0], ctx, memo), eval_expr(e.args[1], ctx, memo))
    elif k == "neg":
        v = _neg(eval_expr(e.args[0], ctx, memo))
    else:
        raise ValueError(f"unknown expr kind {k}")
    memo[e] = v
    return v


def normalize(v: Value, rows: int) -> Value:
    """Broadcast every component to the full (rows,) domain shape.

    Mixed-dim expression arithmetic leaves untouched GL3 components at their
    scalar shapes; downstream code (scans, sorts, stacks) need full
    vectors.
    """
    def b(x: GL) -> GL:
        return x.expand(rows)

    if isinstance(v, GL3):
        return GL3(b(v.c0), b(v.c1), b(v.c2))
    return b(v)


def eval_program(
    prog: List[Tuple[Tuple, Expr]], ctx: EvalContext
) -> Dict[Tuple, Value]:
    """Evaluate a step program; returns dest -> value (shared memoization)."""
    rows = (1 << ctx.info.n_bits) if ctx.domain == "n" else (1 << ctx.info.n_bits_ext)
    memo: Dict[Expr, Value] = {}
    out: Dict[Tuple, Value] = {}
    for dest, expr in prog:
        v = normalize(eval_expr(expr, ctx, memo), rows)
        out[dest] = v
        if dest[0] == "cm":
            # later program entries may reference this column (chained
            # connection im pols) before its section is assembled
            ctx.pending_cm[dest[1]] = v
    return out


# ---------------------------------------------------------------------------
# Host (python-int) evaluation over GF(p^3) scalars — the verifier's path.
# ---------------------------------------------------------------------------


def eval_expr_host(e: Expr, env: Dict) -> Tuple[int, int, int]:
    """Evaluate an expression to a GF(p^3) triple using scalar operands.

    `env` maps: 'cm'/(id,prime) -> triple, 'const'/(id,prime) -> triple,
    'challenge'/id, 'public'/id, 'eval'/id, plus scalars 'x', 'Zi',
    'xDivXSubXi', 'xDivXSubWXi', and 'q'/(id,prime).
    """
    from ..ops.goldilocks import P

    def as3(x):
        if isinstance(x, tuple):
            return x
        return (x % P, 0, 0)

    def add3(a, b):
        return tuple((x + y) % P for x, y in zip(a, b))

    def sub3(a, b):
        return tuple((x - y) % P for x, y in zip(a, b))

    def mul3(a, b):
        a0, a1, a2 = a
        b0, b1, b2 = b
        d0 = a0 * b0
        d1 = a0 * b1 + a1 * b0
        d2 = a0 * b2 + a1 * b1 + a2 * b0
        d3 = a1 * b2 + a2 * b1
        d4 = a2 * b2
        return ((d0 + d3) % P, (d1 + d3 + d4) % P, (d2 + d4) % P)

    k = e.kind
    if k in ("cm", "const", "q"):
        return as3(env[(k, e.id, e.prime)])
    if k in ("challenge", "public", "eval"):
        return as3(env[(k, e.id)])
    if k == "number":
        return (e.value % P, 0, 0)
    if k in ("x", "Zi", "xDivXSubXi", "xDivXSubWXi"):
        return as3(env[k])
    if k == "add":
        return add3(eval_expr_host(e.args[0], env), eval_expr_host(e.args[1], env))
    if k == "sub":
        return sub3(eval_expr_host(e.args[0], env), eval_expr_host(e.args[1], env))
    if k == "mul":
        return mul3(eval_expr_host(e.args[0], env), eval_expr_host(e.args[1], env))
    if k == "neg":
        return sub3((0, 0, 0), eval_expr_host(e.args[0], env))
    raise ValueError(k)
