"""AIR (algebraic intermediate representation) front-end.

The reference prover consumes `zkevm.starkinfo.json`, generated offline by
pil-stark from PIL source.  This module is the framework's own front-end: an
expression IR plus an `AIR` front-end class with committed/constant columns,
polynomial constraints, plookups, permutation arguments, connection
(copy-constraint) arguments and public inputs.  `compiler.py` lowers an AIR
to the same structures the reference engine is driven by (step programs,
puCtx/peCtx/ciCtx, evMap, q split — reference src/starkpil/stark_info.hpp:
105-311).

Expressions are immutable hash-consed nodes; `prime` marks a next-row
rotation (the only rotation the reference supports, see the `(i+1)%N`
accesses in its generated chelpers).
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..ops.goldilocks import P

# expression walks (combined-constraint Horner chains) exceed the default
# python recursion limit at zkEVM scale (675 alpha-chained constraints)
sys.setrecursionlimit(max(sys.getrecursionlimit(), 100_000))

# Leaf kinds and operation kinds
LEAF_KINDS = (
    "cm",          # committed column (id), GL
    "const",       # constant (preprocessed) column (id), GL
    "challenge",   # transcript challenge (id 0..7), GL3
    "public",      # public input (id), GL
    "number",      # literal mod p, GL
    "x",           # domain point (x_n on N-domain, x_2ns on ext domain), GL
    "Zi",          # 1 / Z_H(x) on the ext domain, GL
    "eval",        # evals[id], GL3 (verifier-side / step52ns)
    "xDivXSubXi",  # x/(x-xi) on ext domain, GL3
    "xDivXSubWXi", # x/(x-w*xi) on ext domain, GL3
    "q",           # q chunk polynomial (id) on ext domain, GL3
    "tmpexp",      # materialized expression polynomial (id)
)
OP_KINDS = ("add", "sub", "mul", "neg")


class Expr:
    """Immutable expression node."""

    __slots__ = ("kind", "id", "prime", "value", "args", "_hash")

    def __init__(self, kind, id=None, prime=False, value=None, args=()):
        object.__setattr__(self, "kind", kind)
        object.__setattr__(self, "id", id)
        object.__setattr__(self, "prime", bool(prime))
        object.__setattr__(self, "value", value)
        object.__setattr__(self, "args", tuple(args))
        object.__setattr__(
            self,
            "_hash",
            hash((kind, id, bool(prime), value, tuple(a._hash for a in args))),
        )

    def __setattr__(self, *a):
        raise AttributeError("Expr is immutable")

    # -- structural identity (for CSE) --
    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        if not isinstance(other, Expr):
            return NotImplemented
        return (
            self.kind == other.kind
            and self.id == other.id
            and self.prime == other.prime
            and self.value == other.value
            and self.args == other.args
        )

    # -- arithmetic --
    @staticmethod
    def _coerce(x) -> "Expr":
        if isinstance(x, Expr):
            return x
        if isinstance(x, (int, np.integer)):
            return Expr("number", value=int(x) % P)
        raise TypeError(f"cannot coerce {type(x)} to Expr")

    def __add__(self, other):
        return Expr("add", args=(self, Expr._coerce(other)))

    def __radd__(self, other):
        return Expr("add", args=(Expr._coerce(other), self))

    def __sub__(self, other):
        return Expr("sub", args=(self, Expr._coerce(other)))

    def __rsub__(self, other):
        return Expr("sub", args=(Expr._coerce(other), self))

    def __mul__(self, other):
        return Expr("mul", args=(self, Expr._coerce(other)))

    def __rmul__(self, other):
        return Expr("mul", args=(Expr._coerce(other), self))

    def __neg__(self):
        return Expr("neg", args=(self,))

    def next(self) -> "Expr":
        """Next-row rotation; only valid on cm/const columns."""
        if self.kind not in ("cm", "const"):
            raise ValueError("next() only on committed/constant columns")
        return Expr(self.kind, id=self.id, prime=True)

    # -- analysis --
    def degree(self) -> int:
        if self.kind in ("cm", "const", "tmpexp", "q"):
            return 1
        if self.kind == "x":
            return 1
        if self.kind in ("challenge", "public", "number", "eval",
                         "xDivXSubXi", "xDivXSubWXi", "Zi"):
            return 0
        if self.kind in ("add", "sub"):
            return max(a.degree() for a in self.args)
        if self.kind == "mul":
            return sum(a.degree() for a in self.args)
        if self.kind == "neg":
            return self.args[0].degree()
        raise ValueError(self.kind)

    def __repr__(self):
        if self.kind == "number":
            return str(self.value)
        if self.kind in LEAF_KINDS:
            p = "'" if self.prime else ""
            return f"{self.kind}{self.id}{p}"
        if self.kind == "neg":
            return f"(-{self.args[0]!r})"
        sym = {"add": "+", "sub": "-", "mul": "*"}[self.kind]
        return f"({self.args[0]!r} {sym} {self.args[1]!r})"


def challenge(cid: int) -> Expr:
    return Expr("challenge", id=cid)


# Challenge schedule, identical to reference starks.cpp:67-341
CH_U = 0
CH_DEFVAL = 1
CH_GAMMA = 2
CH_BETA = 3
CH_ALPHA = 4
CH_V1 = 5
CH_V2 = 6
CH_XI = 7


class Lookup:
    """Plookup argument: selected rows of f must appear in selected rows of t."""

    def __init__(self, f_cols, t_cols, f_sel=None, t_sel=None):
        assert len(f_cols) == len(t_cols) and f_cols
        self.f_cols = list(f_cols)
        self.t_cols = list(t_cols)
        self.f_sel = f_sel
        self.t_sel = t_sel


class Permutation:
    """Selected rows of f are a permutation of selected rows of t."""

    def __init__(self, f_cols, t_cols, f_sel=None, t_sel=None):
        assert len(f_cols) == len(t_cols) and f_cols
        self.f_cols = list(f_cols)
        self.t_cols = list(t_cols)
        self.f_sel = f_sel
        self.t_sel = t_sel


class Connection:
    """Plonk-style copy constraints across `cols` given by sigma constant
    columns `s_cols` (values encode k_j * x images under the wiring)."""

    def __init__(self, cols, s_cols):
        assert len(cols) == len(s_cols) and cols
        self.cols = list(cols)
        self.s_cols = list(s_cols)


class AIR:
    """Front end for one STARK circuit ("model" in framework terms)."""

    def __init__(self, name: str, n_bits: int):
        self.name = name
        self.n_bits = n_bits
        self.n = 1 << n_bits
        self.cm_names: List[str] = []
        self.const_names: List[str] = []
        self.const_values: List[np.ndarray] = []
        self.constraints: List[Expr] = []
        self.lookups: List[Lookup] = []
        self.permutations: List[Permutation] = []
        self.connections: List[Connection] = []
        self.publics: List[Tuple[str, int, int]] = []  # (name, cm_id, row)
        self._first_row_col: Optional[Expr] = None
        self._row_sel_cols: Dict[int, Expr] = {}

    # -- columns --
    def committed(self, name: str) -> Expr:
        self.cm_names.append(name)
        return Expr("cm", id=len(self.cm_names) - 1)

    def constant(self, name: str, values) -> Expr:
        vals = np.asarray(values, dtype=np.uint64)
        assert vals.shape == (self.n,), (vals.shape, self.n)
        self.const_names.append(name)
        self.const_values.append(vals % np.uint64(P))
        return Expr("const", id=len(self.const_names) - 1)

    def row_selector(self, row: int) -> Expr:
        """Constant column that is 1 at `row` and 0 elsewhere (cached)."""
        if row not in self._row_sel_cols:
            vals = np.zeros(self.n, dtype=np.uint64)
            vals[row] = 1
            self._row_sel_cols[row] = self.constant(f"__Lrow{row}", vals)
        return self._row_sel_cols[row]

    # -- statements --
    def constraint(self, expr: Expr) -> None:
        self.constraints.append(Expr._coerce(expr))

    def lookup(self, f_cols, t_cols, f_sel=None, t_sel=None) -> None:
        self.lookups.append(Lookup(f_cols, t_cols, f_sel, t_sel))

    def permutation(self, f_cols, t_cols, f_sel=None, t_sel=None) -> None:
        self.permutations.append(Permutation(f_cols, t_cols, f_sel, t_sel))

    def connection(self, cols, s_cols) -> None:
        self.connections.append(Connection(cols, s_cols))

    def public(self, name: str, col: Expr, row: int) -> Expr:
        """Declare a public input pinned to col[row]; returns its Expr."""
        assert col.kind == "cm"
        pid = len(self.publics)
        self.publics.append((name, col.id, row))
        pub = Expr("public", id=pid)
        lrow = self.row_selector(row)
        self.constraint(lrow * (col - pub))
        return pub
