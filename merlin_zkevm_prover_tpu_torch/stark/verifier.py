"""STARK verifier.

The reference has no native verifier — verification happens inside circom
circuits (SURVEY §3, recursion chain).  This framework ships a host
verifier implementing the same checks those circuits perform: transcript
replay, the DEEP constraint identity at xi, Merkle openings of all commit
trees, FRI fold consistency per query, and the final-polynomial degree
bound.  It is the test oracle for the prover and the semantic spec for the
future recursion circuits.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..ops.goldilocks import P, SHIFT, w
from .compiler import StarkInfo
from .evaluator import eval_expr_host
from .host_field import F3, add3, as3, div3, intt_host, inv3, mul3, pow3, sub3
from .merkle_tree import MerkleTreeGL
from .proof import StarkProof
from .transcript import Transcript

HASH_SIZE = 4


class VerifyError(Exception):
    pass


def verify(info: StarkInfo, const_root: List[int], proof: StarkProof,
           publics: Optional[List[int]] = None) -> bool:
    """Full verification; raises VerifyError with a reason on failure."""
    if publics is None:
        publics = proof.publics
    if len(publics) != info.n_publics:
        raise VerifyError("bad publics length")

    n = info.n
    n_ext = info.n_ext

    # ---- transcript replay ----
    t = Transcript()
    t.put(publics)
    challenges: List[Optional[List[int]]] = [None] * 8
    t.put(proof.roots[0])
    challenges[0] = t.get_field()
    challenges[1] = t.get_field()
    t.put(proof.roots[1])
    challenges[2] = t.get_field()
    challenges[3] = t.get_field()
    t.put(proof.roots[2])
    challenges[4] = t.get_field()
    t.put(proof.roots[3])
    challenges[7] = t.get_field()
    for e in proof.evals:
        t.put(e)
    challenges[5] = t.get_field()
    challenges[6] = t.get_field()

    n_steps = len(info.fri_step_bits)
    if len(proof.fri_roots) != n_steps - 1:
        raise VerifyError("bad FRI root count")
    special_xs: List[F3] = []
    for si in range(n_steps):
        special_xs.append(tuple(t.get_field()))
        if si < n_steps - 1:
            t.put(proof.fri_roots[si])
        else:
            if len(proof.final_pol) != 1 << info.fri_step_bits[-1]:
                raise VerifyError("bad final pol size")
            for e in proof.final_pol:
                t.put(e)
    ys = t.get_permutations(info.n_queries, info.fri_step_bits[0])

    xi: F3 = tuple(challenges[7])

    # ---- DEEP constraint identity at xi ----
    env: Dict = {}
    for k, (kind, pid, prime) in enumerate(info.ev_map):
        env[(kind, pid, prime)] = tuple(proof.evals[k])
        env[("eval", k)] = tuple(proof.evals[k])
    for i, c in enumerate(challenges):
        env[("challenge", i)] = tuple(c)
    for i, p in enumerate(publics):
        env[("public", i)] = (int(p) % P, 0, 0)
    xi_n = pow3(xi, n)
    zh = sub3(xi_n, (1, 0, 0))
    env["x"] = xi
    env["Zi"] = inv3(zh)

    c_val = eval_expr_host(info.c_exp, env)
    q_val: F3 = (0, 0, 0)
    for p_i in range(info.q_deg):
        k = info.ev_map.index(("q", p_i, False))
        q_val = add3(q_val, mul3(pow3(xi_n, p_i), tuple(proof.evals[k])))
    if mul3(q_val, zh) != c_val:
        raise VerifyError("constraint identity C(xi) != Q(xi)*Zh(xi) fails")

    # ---- per-query checks ----
    sec2tree = {"cm1_n": "cm1", "cm2_n": "cm2", "cm3_n": "cm3",
                "cm4_2ns": "cm4"}
    roots = {"cm1": proof.roots[0], "cm2": proof.roots[1],
             "cm3": proof.roots[2], "cm4": proof.roots[3],
             "const": list(const_root)}
    w_ext = w(info.n_bits_ext)
    w_n = w(info.n_bits)
    wxi = mul3(xi, (w_n, 0, 0))

    for qi, y0 in enumerate(ys):
        openings = proof.queries_step0[qi]
        for name, root in roots.items():
            op = openings[name]
            if not MerkleTreeGL.verify_proof(root, y0, op.values, op.siblings):
                raise VerifyError(f"Merkle proof failed: tree {name} query {qi}")

        # value of every evMap polynomial at this row
        x_y = (SHIFT * pow(w_ext, y0, P)) % P
        qenv: Dict = dict(env)
        qenv["x"] = (x_y, 0, 0)
        for k, (kind, pid, prime) in enumerate(info.ev_map):
            if kind == "const":
                qenv[("const", pid, False)] = (int(openings["const"].values[pid]), 0, 0)
                continue
            cm_id = info.qs[pid] if kind == "q" else pid
            pm = info.cm_pols[cm_id]
            vals = openings[sec2tree[pm.section]].values
            pos = pm.section_pos
            if pm.dim == 1:
                v: F3 = (int(vals[pos]), 0, 0)
            else:
                v = (int(vals[pos]), int(vals[pos + 1]), int(vals[pos + 2]))
            qenv[(kind, pid, False)] = v
        qenv["xDivXSubXi"] = mul3((x_y, 0, 0), inv3(sub3((x_y, 0, 0), xi)))
        qenv["xDivXSubWXi"] = mul3((x_y, 0, 0), inv3(sub3((x_y, 0, 0), wxi)))

        cur_val = eval_expr_host(info.fri_exp, qenv)

        # FRI fold chain
        cur_y = y0
        shift_inv_cur = pow(SHIFT, P - 2, P)
        pol_bits = info.fri_step_bits[0]
        for si in range(1, n_steps):
            bits = info.fri_step_bits[si]
            y_next = cur_y % (1 << bits)
            j = cur_y >> bits
            opening = proof.queries_fri[si - 1][qi]
            if not MerkleTreeGL.verify_proof(
                proof.fri_roots[si - 1], y_next, opening.values, opening.siblings
            ):
                raise VerifyError(f"FRI Merkle proof failed: step {si} query {qi}")
            group = [
                (int(opening.values[3 * g]), int(opening.values[3 * g + 1]),
                 int(opening.values[3 * g + 2]))
                for g in range(len(opening.values) // 3)
            ]
            if group[j] != tuple(cur_val):
                raise VerifyError(f"FRI consistency failed: step {si} query {qi}")
            # fold the group
            coeffs = intt_host(group)
            sinv_g = (shift_inv_cur * pow(w(pol_bits), P - 1 - y_next, P)) % P
            acc: F3 = (0, 0, 0)
            spx = special_xs[si]
            scale = mul3(spx, (sinv_g, 0, 0))
            for c in reversed(coeffs):
                acc = add3(mul3(acc, scale), c)
            cur_val = acc
            for _ in range(pol_bits - bits):
                shift_inv_cur = shift_inv_cur * shift_inv_cur % P
            pol_bits = bits
            cur_y = y_next

        if tuple(cur_val) != tuple(proof.final_pol[cur_y]):
            raise VerifyError(f"final polynomial mismatch at query {qi}")

    # ---- final polynomial degree bound ----
    final = [tuple(int(x) for x in e) for e in proof.final_pol]
    coeffs = intt_host(final)
    max_deg = 1 << (info.fri_step_bits[-1] - info.blowup_bits)
    for d in range(max_deg, len(coeffs)):
        if coeffs[d] != (0, 0, 0):
            raise VerifyError("final polynomial exceeds degree bound")

    return True
