"""AIR -> StarkInfo compiler.

Produces the same driving structures the reference engine reads from
`*.starkinfo.json` (reference src/starkpil/stark_info.hpp:105-311 and the
pil-stark generator it mirrors): committed-polynomial maps per stage,
plookup/permutation/connection contexts (PuCtx/PeCtx/CiCtx), the five step
programs, the evaluation map, and the quotient split parameters.

Differences from pil-stark, by design:
  * step programs are (dest, Expr) pairs — the evaluator walks the
    expression trees with hash-consed memoization, one whole-domain vector
    op per node, where the reference runs 306k lines of generated C++ (the
    chelpers "parser" form, reference
    zkevm.chelpers.step3.parser.cpp:11-60);
  * grand-product numerators/denominators are always materialized as
    intermediate committed polynomials (cm3), keeping every constraint in
    the combined quotient at degree <= 2 regardless of selector degrees —
    the same role as pil-stark's imPols.

Challenge schedule and transcript order follow reference
src/starkpil/starks.cpp:9-403 exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops.goldilocks import P
from .air import (
    AIR,
    CH_ALPHA,
    CH_BETA,
    CH_DEFVAL,
    CH_GAMMA,
    CH_U,
    CH_V1,
    CH_V2,
    Expr,
    challenge,
)

FIELD_EXTENSION = 3


@dataclass
class PolMap:
    """Where a committed polynomial lives (reference VarPolMap)."""

    stage: int          # 1..4
    section: str        # 'cm1_n' | 'cm2_n' | 'cm3_n' | 'cm4_2ns'
    section_pos: int    # felt offset within the section row
    dim: int            # 1 or 3
    name: str


@dataclass
class PuCtx:
    f_exp_id: int
    t_exp_id: int
    h1_id: int
    h2_id: int
    num_id: int
    den_id: int
    z_id: int


@dataclass
class PeCtx:
    num_id: int
    den_id: int
    z_id: int


@dataclass
class CiCtx:
    num_id: int
    den_id: int
    z_id: int
    # partial-product im pol ids (wide connections chain the 2k-factor
    # product through committed ims so every constraint stays low-degree;
    # pil-stark's imPols do the same job)
    im_ids: List[int] = field(default_factory=list)


@dataclass
class StarkInfo:
    name: str
    n_bits: int
    n_bits_ext: int
    n_queries: int
    fri_step_bits: List[int]           # starkStruct.steps[*].nBits
    n_publics: int
    n_constants: int
    publics: List[Tuple[str, int, int]]
    cm_pols: List[PolMap]
    section_widths: Dict[str, int]
    n_cm: List[int]                    # [nCm1, nCm2, nCm3, nCm4]
    exps: Dict[int, Expr]              # tmpexp id -> defining expression
    exp_dims: Dict[int, int]
    pu_ctx: List[PuCtx]
    pe_ctx: List[PeCtx]
    ci_ctx: List[CiCtx]
    q_deg: int
    q_dim: int
    ev_map: List[Tuple[str, int, bool]]
    c_exp: Expr                        # alpha-combined constraint expression
    fri_exp: Expr
    step2prev: List[Tuple[Tuple, Expr]]
    step3prev: List[Tuple[Tuple, Expr]]
    step42ns: List[Tuple[Tuple, Expr]]
    step52ns: List[Tuple[Tuple, Expr]]
    constraints: List[Expr] = field(default_factory=list)

    @property
    def n(self):
        return 1 << self.n_bits

    @property
    def n_ext(self):
        return 1 << self.n_bits_ext

    @property
    def blowup_bits(self):
        return self.n_bits_ext - self.n_bits

    @property
    def security_bits(self) -> int:
        """Conjectured FRI soundness (no grinding): blowup_bits per query.
        Lowering the blowup (deg-3 systems run at blowup 2) halves the
        per-query contribution — callers must raise n_queries to keep a
        target product (compile_air(security_target_bits=...) does this)."""
        return self.n_queries * self.blowup_bits

    def ev_index(self, kind: str, pid: int, prime: bool) -> int:
        return self.ev_map.index((kind, pid, bool(prime)))

    @property
    def qs(self) -> List[int]:
        """cm pol ids of the q chunks (stage 4)."""
        return [i for i, p in enumerate(self.cm_pols) if p.stage == 4]


def rotate(e: Expr, _memo: Optional[dict] = None) -> Expr:
    """Shift an expression one row forward (prime every column leaf)."""
    if _memo is None:
        _memo = {}
    hit = _memo.get(id(e))
    if hit is not None:
        return hit
    if e.kind in ("cm", "const"):
        if e.prime:
            raise ValueError("double rotation unsupported")
        out = Expr(e.kind, id=e.id, prime=True)
    elif e.kind in ("add", "sub", "mul", "neg"):
        out = Expr(e.kind, args=tuple(rotate(a, _memo) for a in e.args))
    elif e.kind in ("challenge", "public", "number", "eval"):
        out = e
    else:
        raise ValueError(f"cannot rotate {e.kind}")
    _memo[id(e)] = out
    return out


def _compress(cols: List[Expr], ch: Expr) -> Expr:
    """c0 + ch*c1 + ch^2*c2 + ... (Horner from the highest column down)."""
    acc = cols[-1]
    for c in reversed(cols[:-1]):
        acc = acc * ch + c
    return acc


def _expr_dim(e: Expr, cm_dims: Dict[int, int],
              _memo: Optional[dict] = None) -> int:
    if _memo is None:
        _memo = {}
    hit = _memo.get(id(e))
    if hit is not None:
        return hit
    if e.kind == "cm":
        d = cm_dims[e.id]
    elif e.kind in ("const", "number", "public", "x", "Zi"):
        d = 1
    elif e.kind in ("challenge", "eval", "xDivXSubXi", "xDivXSubWXi", "q"):
        d = 3
    elif e.kind == "neg":
        d = _expr_dim(e.args[0], cm_dims, _memo)
    else:
        d = max(_expr_dim(a, cm_dims, _memo) for a in e.args)
    _memo[id(e)] = d
    return d


def _collect_col_refs(e: Expr, out: List[Tuple[str, int, bool]],
                      seen: Optional[set] = None) -> None:
    if seen is None:
        seen = set()
    if id(e) in seen:
        return
    seen.add(id(e))
    if e.kind in ("cm", "const"):
        key = (e.kind, e.id, e.prime)
        if key not in out:
            out.append(key)
    for a in e.args:
        _collect_col_refs(a, out, seen)


def expr_degree(e: Expr, memo: Optional[dict] = None) -> int:
    """Memoized degree over hash-consed DAGs (Expr.degree() walks trees)."""
    if memo is None:
        memo = {}
    hit = memo.get(id(e))
    if hit is not None:
        return hit
    k = e.kind
    if k in ("cm", "const", "tmpexp", "q", "x"):
        d = 1
    elif k in ("challenge", "public", "number", "eval",
               "xDivXSubXi", "xDivXSubWXi", "Zi"):
        d = 0
    elif k in ("add", "sub"):
        d = max(expr_degree(a, memo) for a in e.args)
    elif k == "mul":
        d = sum(expr_degree(a, memo) for a in e.args)
    elif k == "neg":
        d = expr_degree(e.args[0], memo)
    else:
        raise ValueError(k)
    memo[id(e)] = d
    return d


def compile_air(
    air: AIR,
    n_queries: int = 8,
    fri_fold_bits: int = 2,
    final_bits: Optional[int] = None,
    blowup_bits: Optional[int] = None,
    security_target_bits: Optional[int] = None,
) -> StarkInfo:
    """Lower an AIR to a StarkInfo (the proving-key-equivalent structure).

    Soundness note: conjectured FRI security is ~blowup_bits per query
    (no grinding), and blowup is auto-lowered to the constraint-degree
    minimum (deg-3 systems run at blowup 2).  `n_queries` is therefore a
    *floor*: pass `security_target_bits` (production: 100+) to have the
    query count raised to ceil(target / blowup_bits) after the blowup is
    known, instead of hand-tuning per circuit."""
    u = challenge(CH_U)
    defval = challenge(CH_DEFVAL)
    gamma = challenge(CH_GAMMA)
    beta = challenge(CH_BETA)
    alpha = challenge(CH_ALPHA)
    v1 = challenge(CH_V1)
    v2 = challenge(CH_V2)

    # L1 constant column for z boundary constraints (created before freezing
    # the constant set)
    needs_l1 = bool(air.lookups or air.permutations or air.connections)
    l1 = air.row_selector(0) if needs_l1 else None

    cm_pols: List[PolMap] = []
    cm_dims: Dict[int, int] = {}

    def add_cm(stage: int, section: str, dim: int, name: str) -> int:
        pid = len(cm_pols)
        cm_pols.append(PolMap(stage, section, -1, dim, name))
        cm_dims[pid] = dim
        return pid

    # stage 1: the witness trace columns, dim 1
    for name in air.cm_names:
        add_cm(1, "cm1_n", 1, name)
    n_cm1 = len(cm_pols)

    exps: Dict[int, Expr] = {}
    exp_dims: Dict[int, int] = {}

    def add_exp(e: Expr) -> int:
        eid = len(exps)
        exps[eid] = e
        exp_dims[eid] = _expr_dim(e, cm_dims)
        return eid

    constraints: List[Expr] = list(air.constraints)
    pu_ctx: List[PuCtx] = []
    pe_ctx: List[PeCtx] = []
    ci_ctx: List[CiCtx] = []
    step2prev: List[Tuple[Tuple, Expr]] = []
    step3prev: List[Tuple[Tuple, Expr]] = []

    # ---- plookups (stage 2: h1/h2; stage 3: num/den im pols + z) ----
    for li, lk in enumerate(air.lookups):
        f_c = _compress(lk.f_cols, u) if len(lk.f_cols) > 1 else lk.f_cols[0]
        t_c = _compress(lk.t_cols, u) if len(lk.t_cols) > 1 else lk.t_cols[0]
        # selector wrapping, pil-stark starkinfo order: the t side pads
        # unselected rows with the defVal challenge; the f side pads with
        # the (already-wrapped) CURRENT ROW's t value — guaranteed to be
        # in t, unlike defVal (selF-only lookups, e.g. main.pil's memory
        # and hashP reads, would otherwise inject defVal ∉ t)
        if lk.t_sel is not None:
            t_c = lk.t_sel * (t_c - defval) + defval
        if lk.f_sel is not None:
            f_c = lk.f_sel * (f_c - t_c) + t_c
        dim = max(_expr_dim(f_c, cm_dims), _expr_dim(t_c, cm_dims))
        f_id = add_exp(f_c)
        t_id = add_exp(t_c)
        h1 = add_cm(2, "cm2_n", dim, f"lookup{li}.h1")
        h2 = add_cm(2, "cm2_n", dim, f"lookup{li}.h2")
        step2prev.append((("exp", f_id), f_c))
        step2prev.append((("exp", t_id), t_c))
        pu_ctx.append(PuCtx(f_id, t_id, h1, h2, -1, -1, -1))

    # ---- stage-3 grand products ----
    def add_z_argument(kind: str, idx: int, num_e: Expr, den_e: Expr):
        num_id = add_cm(3, "cm3_n", 3, f"{kind}{idx}.num")
        den_id = add_cm(3, "cm3_n", 3, f"{kind}{idx}.den")
        step3prev.append((("cm", num_id), num_e))
        step3prev.append((("cm", den_id), den_e))
        return num_id, den_id

    for li, lk in enumerate(air.lookups):
        pu = pu_ctx[li]
        f_c = exps[pu.f_exp_id]
        t_c = exps[pu.t_exp_id]
        h1 = Expr("cm", id=pu.h1_id)
        h2 = Expr("cm", id=pu.h2_id)
        one_beta = beta + 1
        g1b = gamma * one_beta
        num_e = one_beta * (gamma + f_c) * (g1b + t_c + beta * rotate(t_c))
        den_e = (g1b + h1 + beta * h2) * (g1b + h2 + beta * rotate(h1))
        pu.num_id, pu.den_id = add_z_argument("lookup", li, num_e, den_e)

    for pi, pm in enumerate(air.permutations):
        f_c = _compress(pm.f_cols, u) if len(pm.f_cols) > 1 else pm.f_cols[0]
        t_c = _compress(pm.t_cols, u) if len(pm.t_cols) > 1 else pm.t_cols[0]
        num_e = f_c + gamma
        den_e = t_c + gamma
        if pm.f_sel is not None:
            num_e = pm.f_sel * (num_e - 1) + 1
        if pm.t_sel is not None:
            den_e = pm.t_sel * (den_e - 1) + 1
        num_id, den_id = add_z_argument("perm", pi, num_e, den_e)
        pe_ctx.append(PeCtx(num_id, den_id, -1))

    conn_chain_constraints: List[Expr] = []

    def _chain_product(factors: List[Expr], ci: int, tag: str,
                       im_ids: List[int]) -> int:
        """Materialize prod(factors) through chained cm3 im pols so each
        defining constraint stays degree <= 2 (+1 for the cm itself)."""
        prefix_e = factors[0] if len(factors) == 1 else factors[0] * factors[1]
        imid = add_cm(3, "cm3_n", 3, f"conn{ci}.{tag}.im0")
        step3prev.append((("cm", imid), prefix_e))
        conn_chain_constraints.append(Expr("cm", id=imid) - prefix_e)
        im_ids.append(imid)
        prev = imid
        for k, f in enumerate(factors[2:], start=1):
            prefix_e = prefix_e * f
            imid = add_cm(3, "cm3_n", 3, f"conn{ci}.{tag}.im{k}")
            step3prev.append((("cm", imid), prefix_e))
            conn_chain_constraints.append(
                Expr("cm", id=imid) - Expr("cm", id=prev) * f
            )
            im_ids.append(imid)
            prev = imid
        return prev

    for ci, cn in enumerate(air.connections):
        x = Expr("x")
        nfs: List[Expr] = []
        dfs: List[Expr] = []
        for j, (w, s) in enumerate(zip(cn.cols, cn.s_cols)):
            kj = pow(7, j, P)
            nfs.append(
                w + beta * (x if j == 0 else Expr("number", value=kj) * x) + gamma
            )
            dfs.append(w + beta * s + gamma)
        im_ids: List[int] = []
        num_id = _chain_product(nfs, ci, "num", im_ids)
        den_id = _chain_product(dfs, ci, "den", im_ids)
        ci_ctx.append(CiCtx(num_id, den_id, -1, im_ids))

    # z columns (after all num/den so cm3 layout is [nums/dens..., zs...])
    for li, pu in enumerate(pu_ctx):
        pu.z_id = add_cm(3, "cm3_n", 3, f"lookup{li}.z")
    for pi, pe in enumerate(pe_ctx):
        pe.z_id = add_cm(3, "cm3_n", 3, f"perm{pi}.z")
    for cj, cc in enumerate(ci_ctx):
        cc.z_id = add_cm(3, "cm3_n", 3, f"conn{cj}.z")

    # z constraints + im-pol defining constraints
    for kind, ctxs in (("lookup", pu_ctx), ("perm", pe_ctx), ("conn", ci_ctx)):
        for c in ctxs:
            z = Expr("cm", id=c.z_id)
            num = Expr("cm", id=c.num_id)
            den = Expr("cm", id=c.den_id)
            constraints.append(l1 * (z - 1))
            constraints.append(rotate(z) * den - z * num)
            if kind == "conn":
                continue  # im definitions covered by the chain constraints
            # im definitions: committed num/den must equal their expressions
            num_e = next(e for (d, e) in step3prev if d == ("cm", c.num_id))
            den_e = next(e for (d, e) in step3prev if d == ("cm", c.den_id))
            constraints.append(num - num_e)
            constraints.append(den - den_e)
    constraints.extend(conn_chain_constraints)

    if not constraints:
        raise ValueError("AIR has no constraints")

    # ---- degree lowering via materialized intermediate polynomials ----
    # The zkEVM PIL inlines virtual intermediate pols whose expressions
    # reach degree 9-10 (pilcom nIm = 393); committing them at the blowup
    # those degrees would force (2^4) is a 8x memory/compute tax.  This
    # pass plays pil-stark's calculateImPols role: materialize
    # high-degree subtrees as cm3 pols (computed in step3prev, committed
    # under tree3) until every constraint has degree <= TARGET, giving
    # blowup 2 / q_deg 2 — the reference's own zkevm starkstruct shape.
    TARGET = 3
    deg_memo: dict = {}

    def deg(e: Expr) -> int:
        return expr_degree(e, deg_memo)

    im_memo: Dict[Expr, Expr] = {}
    lowered_defs: List[Expr] = []

    def materialize(e: Expr) -> Expr:
        im = im_memo.get(e)
        if im is None:
            d = _expr_dim(e, cm_dims)
            imid = add_cm(3, "cm3_n", d, f"im{len(im_memo)}")
            step3prev.append((("cm", imid), e))
            im = Expr("cm", id=imid)
            lowered_defs.append(im - e)  # e is reduced: deg <= TARGET
            im_memo[e] = im
        return im

    red_memo: Dict[Expr, Expr] = {}

    def reduce_deg(e: Expr) -> Expr:
        if deg(e) <= TARGET:
            return e
        r = red_memo.get(e)
        if r is not None:
            return r
        if e.kind == "mul":
            a, b = reduce_deg(e.args[0]), reduce_deg(e.args[1])
            while deg(a) + deg(b) > TARGET:
                if deg(a) >= deg(b) and deg(a) > 1:
                    a = materialize(a)
                elif deg(b) > 1:
                    b = materialize(b)
                else:
                    break
            r = Expr("mul", args=(a, b))
        elif e.kind in ("add", "sub", "neg"):
            r = Expr(e.kind, args=tuple(reduce_deg(a) for a in e.args))
        else:  # leaves have degree <= 1 <= TARGET
            raise AssertionError(e.kind)
        red_memo[e] = r
        return r

    constraints = [reduce_deg(c) for c in constraints]
    constraints.extend(lowered_defs)

    # ---- quotient parameters ----
    max_deg = max(max(expr_degree(c, deg_memo) for c in constraints), 1)
    # the true quotient degree is (max_deg-1)*n - max_deg < (max_deg-1)*n,
    # and q is evaluated pointwise on the coset (each committed pol's LDE
    # is exact there), so an ext domain of 2^k*n with 2^k >= max_deg-1
    # determines q exactly: deg-3 constraint systems (the zkEVM PIL) run
    # at blowup 2 with q split into 2 chunks, matching pil-stark's
    # zkevm starkstruct (nBitsExt = nBits+1, qDeg = 2)
    need_blowup = max(1, (max_deg - 2).bit_length())
    if blowup_bits is None:
        blowup_bits = need_blowup
    assert blowup_bits >= need_blowup, (
        f"blowup 2^{blowup_bits} too small for constraint degree {max_deg}"
    )
    q_deg = max(max_deg - 1, 1)
    n_bits_ext = air.n_bits + blowup_bits
    if security_target_bits is not None:
        n_queries = max(n_queries,
                        -(-security_target_bits // blowup_bits))

    # combined constraint polynomial (Horner in alpha, pil-stark style).
    # The tree form drives the verifier; the prover evaluates the step42ns
    # program as independent per-constraint dests and alpha-combines them
    # in a Horner loop (device_core.step4_chunk).
    c_exp = constraints[0]
    for c in constraints[1:]:
        c_exp = c_exp * alpha + c
    step42ns = [(("cstr", k), c) for k, c in enumerate(constraints)]

    # stage 4: q chunks
    for p in range(q_deg):
        add_cm(4, "cm4_2ns", FIELD_EXTENSION, f"q{p}")

    # ---- evaluation map ----
    ev_map: List[Tuple[str, int, bool]] = []
    refs: List[Tuple[str, int, bool]] = []
    _collect_col_refs(c_exp, refs)
    for kind, pid, prime in refs:
        if (kind, pid, prime) not in ev_map:
            ev_map.append((kind, pid, prime))
    for p in range(q_deg):
        ev_map.append(("q", p, False))

    # ---- FRI polynomial ----
    # Tree form (verifier) + per-term program (prover; scan-combined).
    acc = None
    acc_w = None
    step52ns = []
    for k, (kind, pid, prime) in enumerate(ev_map):
        if kind == "cm":
            p_e = Expr("cm", id=pid)
        elif kind == "const":
            p_e = Expr("const", id=pid)
        else:
            p_e = Expr("q", id=pid)
        term = p_e - Expr("eval", id=k)
        step52ns.append((("fterm", k), term))
        if prime:
            acc_w = term if acc_w is None else acc_w * v1 + term
        else:
            acc = term if acc is None else acc * v1 + term
    fri_exp = acc * Expr("xDivXSubXi")
    if acc_w is not None:
        fri_exp = fri_exp + v2 * acc_w * Expr("xDivXSubWXi")

    # ---- FRI step schedule ----
    if final_bits is None:
        final_bits = max(n_bits_ext - 3 * fri_fold_bits, min(6, n_bits_ext))
    fri_step_bits = [n_bits_ext]
    cur = n_bits_ext
    while cur - fri_fold_bits >= final_bits:
        cur -= fri_fold_bits
        fri_step_bits.append(cur)

    # ---- section layout ----
    section_widths = {"cm1_n": 0, "cm2_n": 0, "cm3_n": 0, "cm4_2ns": 0}
    for pm in cm_pols:
        pm.section_pos = section_widths[pm.section]
        section_widths[pm.section] += pm.dim

    n_cm = [
        sum(1 for p in cm_pols if p.stage == s) for s in (1, 2, 3, 4)
    ]

    return StarkInfo(
        name=air.name,
        n_bits=air.n_bits,
        n_bits_ext=n_bits_ext,
        n_queries=n_queries,
        fri_step_bits=fri_step_bits,
        n_publics=len(air.publics),
        n_constants=len(air.const_names),
        publics=list(air.publics),
        cm_pols=cm_pols,
        section_widths=section_widths,
        n_cm=n_cm,
        exps=exps,
        exp_dims=exp_dims,
        pu_ctx=pu_ctx,
        pe_ctx=pe_ctx,
        ci_ctx=ci_ctx,
        q_deg=q_deg,
        q_dim=FIELD_EXTENSION,
        ev_map=ev_map,
        c_exp=c_exp,
        fri_exp=fri_exp,
        step2prev=step2prev,
        step3prev=step3prev,
        step42ns=step42ns,
        step52ns=step52ns,
        constraints=constraints,
    )
