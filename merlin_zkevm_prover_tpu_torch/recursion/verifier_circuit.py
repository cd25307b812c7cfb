"""STARK verifier expressed as a gate circuit (the recursion step).

This is the native equivalent of the reference's circom verifier circuits
(zkevm.verifier / recursive1 / recursive2 — reference
src/starkpil/*/witness/, src/prover/prover.cpp:394-949): the host verifier
in stark/verifier.py re-expressed over `Circuit` wires, so that proving
the resulting plonk12c AIR (recursion/plonk.py) attests to the validity of
the inner proof.

Structure per inner proof (mirroring stark/verifier.py line for line):
  1. transcript replay (CTranscript — Poseidon sponge as 31-row blocks);
  2. DEEP constraint identity at xi: walk info.c_exp emitting GF(p^3) gates;
  3. per query: Merkle openings of cm1..cm4/const trees, info.fri_exp
     evaluation, FRI fold chain with group INTT as a constant linear map,
     final-polynomial consistency;
  4. final-polynomial degree bound (constant INTT + zero asserts).

Query indices come from in-circuit bit decomposition of transcript felts
with a canonicity check (value < p), making the derived indices unique —
the soundness-critical detail of Fiat-Shamir in-circuit.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..ops.goldilocks import P, SHIFT, w as gl_w, w_inv as gl_w_inv
from ..stark.compiler import StarkInfo
from ..stark.proof import StarkProof
from .gates import Circuit, W3

HASH = 4
RATE = 8
OUT = 12


class CTranscript:
    """In-circuit Fiat-Shamir, exact mirror of stark/transcript.py."""

    def __init__(self, c: Circuit):
        self.c = c
        self.state = [c.zero] * HASH
        self.pending: List[int] = []
        self.out: List[int] = []
        self.out_cursor = 0

    def put(self, wires: Sequence[int]) -> None:
        for w in wires:
            self.pending.append(w)
            self.out_cursor = 0
            if len(self.pending) == RATE:
                self._squeeze()

    def _squeeze(self) -> None:
        inputs = self.pending + [self.c.zero] * (RATE - len(self.pending))
        inputs += self.state
        self.out = self.c.poseidon(inputs)
        self.out_cursor = OUT
        self.pending = []
        self.state = self.out[:HASH]

    def get_fields1(self) -> int:
        if self.out_cursor == 0:
            self._squeeze()
        res = self.out[(OUT - self.out_cursor) % OUT]
        self.out_cursor -= 1
        return res

    def get_field(self) -> W3:
        return (self.get_fields1(), self.get_fields1(), self.get_fields1())

    def get_permutation_bits(self, n: int, n_bits: int) -> List[List[int]]:
        """n query indices as little-endian bit-wire lists."""
        total_bits = n * n_bits
        n_fields = (total_bits - 1) // 63 + 1
        stream: List[int] = []
        for _ in range(n_fields):
            f = self.get_fields1()
            bits = self.c.decompose_canonical_64(f)
            stream.extend(bits[:63])
        return [stream[i * n_bits: (i + 1) * n_bits] for i in range(n)]


# ---------------------------------------------------------------------------
# gadgets
# ---------------------------------------------------------------------------


def pow_bits(c: Circuit, base: int, bits: Sequence[int]) -> int:
    """base^y as a wire, y given little-endian as bit wires (base static)."""
    acc = c.one
    cur = base % P
    for b in bits:
        term = c.add_const(c.mul_const(b, (cur - 1) % P), 1)
        acc = c.mul(acc, term)
        cur = cur * cur % P
    return acc


def select_many(c: Circuit, bits: Sequence[int], items: List) -> object:
    """Binary-tree select of items[y] (len == 2^len(bits)); items are wires
    or wire tuples."""
    assert len(items) == 1 << len(bits)
    layer = list(items)
    for b in bits:
        nxt = []
        for i in range(0, len(layer), 2):
            lo, hi = layer[i], layer[i + 1]
            if isinstance(lo, tuple):
                nxt.append(tuple(c.select(b, h, l) for l, h in zip(lo, hi)))
            else:
                nxt.append(c.select(b, hi, lo))
        layer = nxt
    return layer[0]


def linear_hash_gadget(c: Circuit, values: List[int]) -> List[int]:
    """poseidon_gl.linear_hash_host over wires."""
    if len(values) <= HASH:
        return values + [c.zero] * (HASH - len(values))
    digest = [c.zero] * HASH
    for off in range(0, len(values), RATE):
        chunk = values[off: off + RATE]
        chunk = chunk + [c.zero] * (RATE - len(chunk))
        digest = c.poseidon(chunk + digest)[:HASH]
    return digest


def merkle_verify_gadget(c: Circuit, root: List[int], values: List[int],
                         path_bits: List[int],
                         siblings: List[List[int]]) -> None:
    """Recompute the root from an opened row + sibling path; assert equal.

    Same walk as MerkleTreeGL.verify_proof (merkleTreeGL.cpp:24-35): level
    bit 1 means current digest is the right child.
    """
    assert len(path_bits) == len(siblings)
    h = linear_hash_gadget(c, values)
    for bit, sib in zip(path_bits, siblings):
        left = [c.select(bit, s, x) for s, x in zip(sib, h)]
        right = [c.select(bit, x, s) for s, x in zip(sib, h)]
        h = c.poseidon(left + right + [c.zero] * HASH)[:HASH]
    for a, b in zip(h, root):
        c.assert_eq(a, b)


def eval_expr_gates(c: Circuit, e, env: Dict, memo: Dict) -> W3:
    """GF(p^3) gate evaluation of a compiler Expr (mirror of
    stark/evaluator.eval_expr_host)."""
    hit = memo.get(e)
    if hit is not None:
        return hit
    k = e.kind
    if k in ("cm", "const", "q"):
        v = c.as3(env[(k, e.id, e.prime)])
    elif k in ("challenge", "public", "eval"):
        v = c.as3(env[(k, e.id)])
    elif k == "number":
        v = c.const3(e.value % P)
    elif k in ("x", "Zi", "xDivXSubXi", "xDivXSubWXi"):
        v = c.as3(env[k])
    elif k == "add":
        v = c.add3(eval_expr_gates(c, e.args[0], env, memo),
                   eval_expr_gates(c, e.args[1], env, memo))
    elif k == "sub":
        v = c.sub3(eval_expr_gates(c, e.args[0], env, memo),
                   eval_expr_gates(c, e.args[1], env, memo))
    elif k == "mul":
        v = c.mul3(eval_expr_gates(c, e.args[0], env, memo),
                   eval_expr_gates(c, e.args[1], env, memo))
    elif k == "neg":
        v = c.sub3(c.const3(0), eval_expr_gates(c, e.args[0], env, memo))
    else:
        raise ValueError(f"unsupported expr kind in circuit: {k}")
    memo[e] = v
    return v


def intt_const_rows(n: int) -> List[List[int]]:
    """INTT matrix: coeffs[i] = (1/n) sum_j w^(-ij) vals[j] (host ints)."""
    wi = gl_w_inv(int(n).bit_length() - 1)
    ninv = pow(n, P - 2, P)
    return [[pow(wi, (i * j) % (P - 1), P) * ninv % P for j in range(n)]
            for i in range(n)]


def _lc3(c: Circuit, coefs: List[int], vals: List[W3]) -> W3:
    """sum(coef_j * val_j) for GL constant coefs over GF(p^3) wire triples."""
    comps = []
    for comp in range(3):
        comps.append(c.lc([(coefs[j], vals[j][comp])
                           for j in range(len(vals))]))
    return tuple(comps)


# ---------------------------------------------------------------------------
# the verifier
# ---------------------------------------------------------------------------


def add_stark_verifier(c: Circuit, info: StarkInfo, proof: StarkProof,
                       publics: List[int],
                       const_root: List[int]) -> None:
    """Emit gates verifying `proof` (witness) against `publics`/`const_root`
    (wires, typically public inputs).  Raises on an invalid witness proof.

    Mirrors stark/verifier.verify step for step.
    """
    n_bits = info.n_bits
    n = info.n

    # ---- proof ingestion as witness wires ----
    roots = [[c.witness(v) for v in r] for r in proof.roots]
    evals = [tuple(c.witness(v % P) for v in e) for e in proof.evals]
    fri_roots = [[c.witness(v) for v in r] for r in proof.fri_roots]
    final_pol = [tuple(c.witness(v % P) for v in e) for e in proof.final_pol]

    # ---- transcript replay ----
    t = CTranscript(c)
    t.put(publics)
    challenges: List[Optional[W3]] = [None] * 8
    t.put(roots[0])
    challenges[0] = t.get_field()
    challenges[1] = t.get_field()
    t.put(roots[1])
    challenges[2] = t.get_field()
    challenges[3] = t.get_field()
    t.put(roots[2])
    challenges[4] = t.get_field()
    t.put(roots[3])
    challenges[7] = t.get_field()
    for e in evals:
        t.put(list(e))
    challenges[5] = t.get_field()
    challenges[6] = t.get_field()

    n_steps = len(info.fri_step_bits)
    assert len(proof.fri_roots) == n_steps - 1, "bad FRI root count"
    special_xs: List[W3] = []
    for si in range(n_steps):
        special_xs.append(t.get_field())
        if si < n_steps - 1:
            t.put(fri_roots[si])
        else:
            assert len(final_pol) == 1 << info.fri_step_bits[-1]
            for e in final_pol:
                t.put(list(e))
    ys_bits = t.get_permutation_bits(info.n_queries, info.fri_step_bits[0])

    xi = challenges[7]

    # ---- DEEP constraint identity at xi ----
    env: Dict = {}
    for k, (kind, pid, prime) in enumerate(info.ev_map):
        env[(kind, pid, prime)] = evals[k]
        env[("eval", k)] = evals[k]
    for i, ch in enumerate(challenges):
        env[("challenge", i)] = ch
    for i, pw in enumerate(publics):
        env[("public", i)] = c.as3(pw)
    xi_n = xi
    for _ in range(n_bits):
        xi_n = c.mul3(xi_n, xi_n)
    zh = c.sub3(xi_n, c.const3(1))
    env["x"] = xi
    env["Zi"] = c.inv3(zh)

    memo: Dict = {}
    c_val = eval_expr_gates(c, info.c_exp, env, memo)
    q_val = c.const3(0)
    for p_i in reversed(range(info.q_deg)):
        k = info.ev_map.index(("q", p_i, False))
        q_val = c.add3(c.mul3(q_val, xi_n), evals[k])
    c.assert_eq3(c.mul3(q_val, zh), c_val)

    # ---- per-query checks ----
    sec2tree = {"cm1_n": "cm1", "cm2_n": "cm2", "cm3_n": "cm3",
                "cm4_2ns": "cm4"}
    tree_roots = {"cm1": roots[0], "cm2": roots[1], "cm3": roots[2],
                  "cm4": roots[3], "const": const_root}
    w_ext = gl_w(info.n_bits_ext)
    w_n = gl_w(n_bits)
    wxi = c.mul3_const(xi, (w_n, 0, 0))
    n_levels = info.n_bits_ext  # tree height 2^n_bits_ext

    for qi in range(info.n_queries):
        y_bits = ys_bits[qi]
        openings = proof.queries_step0[qi]
        op_wires: Dict[str, List[int]] = {}
        for name, root in tree_roots.items():
            op = openings[name]
            vals = [c.witness(v % P) for v in op.values]
            sibs = [[c.witness(v % P) for v in s] for s in op.siblings]
            assert len(sibs) == n_levels
            merkle_verify_gadget(c, root, vals, y_bits, sibs)
            op_wires[name] = vals

        x_y = c.mul_const(pow_bits(c, w_ext, y_bits), SHIFT)
        qenv: Dict = dict(env)
        qenv["x"] = c.as3(x_y)
        for k, (kind, pid, prime) in enumerate(info.ev_map):
            if kind == "const":
                qenv[("const", pid, False)] = c.as3(op_wires["const"][pid])
                continue
            cm_id = info.qs[pid] if kind == "q" else pid
            pm = info.cm_pols[cm_id]
            vals = op_wires[sec2tree[pm.section]]
            pos = pm.section_pos
            if pm.dim == 1:
                qenv[(kind, pid, False)] = c.as3(vals[pos])
            else:
                qenv[(kind, pid, False)] = (vals[pos], vals[pos + 1],
                                            vals[pos + 2])
        x3 = c.as3(x_y)
        qenv["xDivXSubXi"] = c.mul3(x3, c.inv3(c.sub3(x3, xi)))
        qenv["xDivXSubWXi"] = c.mul3(x3, c.inv3(c.sub3(x3, wxi)))

        qmemo: Dict = {}
        cur_val = eval_expr_gates(c, info.fri_exp, qenv, qmemo)

        # ---- FRI fold chain ----
        cur_bits = y_bits
        shift_inv_cur = pow(SHIFT, P - 2, P)
        pol_bits = info.fri_step_bits[0]
        for si in range(1, n_steps):
            bits = info.fri_step_bits[si]
            y_next_bits = cur_bits[:bits]
            j_bits = cur_bits[bits:]
            gsz = 1 << (pol_bits - bits)
            opening = proof.queries_fri[si - 1][qi]
            vals = [c.witness(v % P) for v in opening.values]
            sibs = [[c.witness(v % P) for v in s] for s in opening.siblings]
            merkle_verify_gadget(c, tuple_root(fri_roots[si - 1]), vals,
                                 y_next_bits, sibs)
            group: List[W3] = [
                (vals[3 * g], vals[3 * g + 1], vals[3 * g + 2])
                for g in range(gsz)
            ]
            sel = select_many(c, j_bits, [g[0] for g in group]), \
                select_many(c, j_bits, [g[1] for g in group]), \
                select_many(c, j_bits, [g[2] for g in group])
            c.assert_eq3(sel, cur_val)

            rowsM = intt_const_rows(gsz)
            coeffs = [_lc3(c, rowsM[i], group) for i in range(gsz)]
            wneg = [pow(gl_w(pol_bits), P - 1 - (1 << i) % (P - 1), P)
                    for i in range(bits)]
            wy = c.one
            for i, b in enumerate(y_next_bits):
                term = c.add_const(c.mul_const(b, (wneg[i] - 1) % P), 1)
                wy = c.mul(wy, term)
            sinv_g = c.mul_const(wy, shift_inv_cur)
            spx = special_xs[si]
            scale = c.mul3_base(spx, sinv_g)
            acc = c.const3(0)
            for coef in reversed(coeffs):
                acc = c.add3(c.mul3(acc, scale), coef)
            cur_val = acc
            for _ in range(pol_bits - bits):
                shift_inv_cur = shift_inv_cur * shift_inv_cur % P
            pol_bits = bits
            cur_bits = y_next_bits

        fsel = (select_many(c, cur_bits, [f[0] for f in final_pol]),
                select_many(c, cur_bits, [f[1] for f in final_pol]),
                select_many(c, cur_bits, [f[2] for f in final_pol]))
        c.assert_eq3(cur_val, fsel)

    # ---- final polynomial degree bound ----
    m = len(final_pol)
    rowsM = intt_const_rows(m)
    max_deg = 1 << (info.fri_step_bits[-1] - info.blowup_bits)
    for d in range(max_deg, m):
        coef = _lc3(c, rowsM[d], final_pol)
        for comp in coef:
            c.assert_zero(comp)


def tuple_root(r: List[int]) -> List[int]:
    return r
