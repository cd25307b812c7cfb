"""Device-side STARK stage functions.

Each function is a pure map from device tensors to device tensors, with the
circuit's StarkInfo as a static argument — the host prover (prover.py)
interleaves them with the sequential Fiat-Shamir transcript (the
reference's per-stage structure, with the host/device split at exactly the
transcript interactions).

Two halves.  The small-circuit half runs expression programs on the tree
evaluator in node-count-bounded chunks (a fresh memo per chunk bounds how
many whole-domain intermediates are alive at once) and step 5 in the
per-polynomial form.  The large-circuit half runs steps 2-4 on the VM
(``stark/vm.py``: one interpreter launch per program) and step 5 as
weighted column sums; the prover picks a half per step by program size.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops import goldilocks3 as gl3
from ..ops import ntt as nttmod
from ..ops.goldilocks import GL, P, SHIFT
from ..ops.goldilocks3 import GL3
from . import vm as vm_mod
from .compiler import StarkInfo
from .evaluator import EvalContext, eval_expr, eval_program, normalize


def _assemble_section(rows: int, width: int, cols: Dict[int, object],
                      info: StarkInfo, section: str, device) -> GL:
    out = torch.zeros((rows, width), dtype=torch.int64, device=device)
    for pid, val in cols.items():
        pm = info.cm_pols[pid]
        assert pm.section == section
        if pm.dim == 3 and not isinstance(val, GL3):
            val = gl3.from_base(val)
        pos = pm.section_pos
        if pm.dim == 1:
            out[:, pos] = val
        else:
            out[:, pos] = val.c0
            out[:, pos + 1] = val.c1
            out[:, pos + 2] = val.c2
    return out


def _gl3_to_mat(v: GL3) -> GL:
    return torch.stack([v.c0, v.c1, v.c2], dim=1)


def _mat_to_gl3(m: GL) -> GL3:
    return GL3(m[:, 0], m[:, 1], m[:, 2])


def extend_section(info: StarkInfo, section_n: GL) -> GL:
    """LDE of an n-domain section, column-blocked (the tree is built
    separately)."""
    if section_n.shape[1] == 0:
        return section_n.new_zeros((info.n_ext, 0))
    return nttmod.extend_pol_blocked(section_n, info.n_bits, info.n_bits_ext)


def step4_chunk(info: StarkInfo, k0: int, k1: int, sections: Dict[str, GL],
                const_2ns: GL, challenges: GL3, publics: GL, x_2ns: GL,
                zi: GL, acc: GL3) -> GL3:
    """Horner-accumulate constraints [k0, k1) into the alpha-combined
    quotient numerator: acc' = acc * alpha^(k1-k0) + sum alpha^i c_i.

    Constraint batches evaluate with a fresh memo each, the running
    accumulator carried across (same Horner order as the verifier's c_exp
    tree): a wide circuit's constraint vectors are never all alive."""
    ctx = EvalContext(info=info, domain="ext", sections=sections,
                      const=const_2ns, challenges=challenges, publics=publics,
                      x=x_2ns, zi=zi)
    prog = info.step42ns[k0:k1]
    cvals = eval_program(prog, ctx)
    alpha = challenges[4]
    for k in range(k0, k1):
        c = cvals[("cstr", k)]
        if not isinstance(c, GL3):
            c = gl3.from_base(c)
        acc = gl3.add(gl3.mul(acc, alpha), c)
    return acc


def step4_finalize(info: StarkInfo, q_val: GL3, zi: GL) -> GL:
    """q = numerator * Zi -> INTT -> q_deg coefficient chunks -> NTT."""
    n, n_ext = info.n, info.n_ext
    q_val = gl3.mul_base(q_val, zi)
    d = nttmod.intt(_gl3_to_mat(q_val))
    shift_in = pow(pow(SHIFT, P - 2, P), n, P)
    q_coeffs = d.new_zeros((n_ext, 3 * info.q_deg))
    for p_i in range(info.q_deg):
        chunk = d[p_i * n: (p_i + 1) * n]
        q_coeffs[:n, 3 * p_i: 3 * p_i + 3] = gl.mul(chunk, pow(shift_in, p_i, P))
    return nttmod.ntt(q_coeffs)


def ev_pol_values(info: StarkInfo, kind: str, pid: int,
                  sections: Dict[str, GL], const_2ns: GL):
    """The N base-domain values of one polynomial: every blow-th row of its
    extended column (a strided view)."""
    blow = 1 << info.blowup_bits
    if kind == "const":
        return const_2ns[::blow, pid]
    pm = info.cm_pols[info.qs[pid] if kind == "q" else pid]
    section = pm.section if pm.section == "cm4_2ns" else \
        pm.section.replace("_n", "_2ns")
    mat = sections[section]
    pos = pm.section_pos
    if pm.dim == 1:
        return mat[::blow, pos]
    return GL3(mat[::blow, pos], mat[::blow, pos + 1], mat[::blow, pos + 2])


def _intt3(v: GL3) -> GL3:
    return _mat_to_gl3(nttmod.intt(_gl3_to_mat(v)))


def step5_evals(info: StarkInfo, sections: Dict[str, GL], const_2ns: GL,
                xi: GL3) -> GL3:
    """The evaluation map: evals[k] = p_k(xi or w*xi).  Returns (size_eval,).

    evmap as an inner-product against INTT'd power vectors — the reference's
    matrix-vector formulation with the dot products as log-depth tree
    reductions.
    """
    n = info.n
    shift_inv = pow(SHIFT, P - 2, P)
    w_n = gl.w(info.n_bits)
    xis = gl3.mul_base(xi, shift_inv)
    wxis = gl3.mul_base(gl3.mul_base(xi, w_n), shift_inv)
    lev_c = _intt3(gl3.powers_scan(xis, n))
    lpev_c = _intt3(gl3.powers_scan(wxis, n))
    out: List[GL3] = []
    for (kind, pid, prime) in info.ev_map:
        vals = ev_pol_values(info, kind, pid, sections, const_2ns)
        lcoef = lpev_c if prime else lev_c
        if isinstance(vals, GL3):
            prod = gl3.mul(vals, lcoef)
        else:
            prod = gl3.mul_base(lcoef, vals)
        out.append(gl3.sum_axis0(prod))
    return gl3.stack(out, axis=0)


def x_div_x_sub(x_2ns: GL, point: GL3) -> GL3:
    diff = GL3(
        gl.sub(x_2ns, point.c0),
        gl.neg(point.c1).expand(x_2ns.shape),
        gl.neg(point.c2).expand(x_2ns.shape),
    )
    return gl3.mul_base(gl3.batch_inverse_parallel(diff), x_2ns)


def step5_fri_pol(info: StarkInfo, sections: Dict[str, GL], const_2ns: GL,
                  challenges: GL3, publics: GL, x_2ns: GL, zi: GL,
                  evals: GL3, xi: GL3) -> GL3:
    w_n = gl.w(info.n_bits)
    wxi = gl3.mul_base(xi, w_n)
    xdiv = x_div_x_sub(x_2ns, xi)
    xdivw = x_div_x_sub(x_2ns, wxi)
    ctx = EvalContext(info=info, domain="ext", sections=sections,
                      const=const_2ns, challenges=challenges, publics=publics,
                      x=x_2ns, zi=zi, evals=evals,
                      x_div_x_sub_xi=xdiv, x_div_x_sub_wxi=xdivw)
    v1 = challenges[5]
    v2 = challenges[6]
    # stream the Horner folds term by term: each term is evaluated with a
    # fresh memo, folded into its accumulator, and freed, so a long
    # evaluation map never holds all its whole-domain vectors at once
    prog = {dest[1]: expr for dest, expr in info.step52ns}
    acc_p: Optional[GL3] = None
    acc_w: Optional[GL3] = None
    for k, (_, _, primed) in enumerate(info.ev_map):
        t = normalize(eval_expr(prog[k], ctx, {}), info.n_ext)
        if not isinstance(t, GL3):
            t = gl3.from_base(t)
        if primed:
            acc_w = t if acc_w is None else gl3.add(gl3.mul(acc_w, v1), t)
        else:
            acc_p = t if acc_p is None else gl3.add(gl3.mul(acc_p, v1), t)
    f_val = gl3.mul(acc_p, xdiv)
    if acc_w is not None:
        f_val = gl3.add(f_val, gl3.mul(gl3.mul(acc_w, v2), xdivw))
    return f_val


# ---------------------------------------------------------------------------
# Chunk planning: bound the number of expression nodes (and with them the
# whole-domain intermediates a memo keeps alive) per evaluation.
# ---------------------------------------------------------------------------


def _expr_new_nodes(e, seen: set) -> int:
    """Count nodes of `e` not already in `seen` (adds them)."""
    stack = [e]
    n = 0
    while stack:
        x = stack.pop()
        if id(x) in seen:
            continue
        seen.add(id(x))
        n += 1
        stack.extend(x.args)
    return n


def plan_program_chunks(prog, max_nodes: int):
    """Split a step program into [e0, e1) spans whose per-chunk (fresh
    memo) node counts stay <= max_nodes (single oversized entries get
    their own span)."""
    spans = []
    e0 = 0
    seen: set = set()
    count = 0
    for i, (_dest, expr) in enumerate(prog):
        c = _expr_new_nodes(expr, seen)
        if count and count + c > max_nodes:
            spans.append((e0, i))
            e0 = i
            seen = set()
            count = _expr_new_nodes(expr, seen)
        else:
            count += c
    if e0 < len(prog):
        spans.append((e0, len(prog)))
    return spans


def _collect_cm_ids(e, out: set, seen: set) -> None:
    stack = [e]
    while stack:
        x = stack.pop()
        if id(x) in seen:
            continue
        seen.add(id(x))
        if x.kind == "cm":
            out.add(x.id)
        stack.extend(x.args)


def chunk_pending_inputs(prog, spans):
    """For each span, the cm ids referenced by its exprs that are dests of
    EARLIER program entries (must be fed in as pending values)."""
    dest_at = {}
    for i, (dest, _e) in enumerate(prog):
        if dest[0] == "cm":
            dest_at[dest[1]] = i
    needs = []
    for (e0, e1) in spans:
        refs: set = set()
        seen: set = set()
        for (_d, e) in prog[e0:e1]:
            _collect_cm_ids(e, refs, seen)
        needs.append(sorted(r for r in refs
                            if r in dest_at and dest_at[r] < e0))
    return needs


def step2_exprs_chunk(info: StarkInfo, e0: int, e1: int,
                      sections: Dict[str, GL], const_n: GL,
                      challenges: GL3, publics: GL, x_n: GL):
    """Evaluate step2prev[e0:e1] (f/t expressions); returns exp id ->
    value."""
    ctx = EvalContext(info=info, domain="n", sections=sections, const=const_n,
                      challenges=challenges, publics=publics, x=x_n)
    exp_vals = eval_program(info.step2prev[e0:e1], ctx)
    return {dest[1]: v for dest, v in exp_vals.items()}


def step2_assemble(info: StarkInfo, h_cols: Dict[int, object], device):
    """h1/h2 columns -> cm2_n section matrix."""
    w2 = info.section_widths["cm2_n"]
    return _assemble_section(info.n, w2, h_cols, info, "cm2_n", device)


def step3_exprs_chunk(info: StarkInfo, e0: int, e1: int,
                      sections: Dict[str, GL], const_n: GL,
                      challenges: GL3, publics: GL, x_n: GL,
                      pending: Dict[int, object]) -> Dict[int, object]:
    """Evaluate step3prev[e0:e1] with earlier chunk results fed as pending
    cm values; returns this chunk's computed cm columns."""
    ctx = EvalContext(info=info, domain="n", sections=sections, const=const_n,
                      challenges=challenges, publics=publics, x=x_n,
                      pending_cm=dict(pending))
    out: Dict[int, object] = {}
    memo: Dict = {}
    rows = info.n
    for dest, expr in info.step3prev[e0:e1]:
        v = normalize(eval_expr(expr, ctx, memo), rows)
        ctx.pending_cm[dest[1]] = v
        out[dest[1]] = v
    return out


def step3_assemble(info: StarkInfo, cols: Dict[int, object], device) -> GL:
    w3 = info.section_widths["cm3_n"]
    return _assemble_section(info.n, w3, cols, info, "cm3_n", device)


def step4_span_chunks(info: StarkInfo, max_nodes: int):
    """Constraint spans for step4 bounded by expression node count."""
    return [(s[0], s[1])
            for s in plan_program_chunks(info.step42ns, max_nodes)]


# ---------------------------------------------------------------------------
# Large circuits: the evaluation map and FRI polynomial as weighted column
# sums, steps 2-4 on the VM
# ---------------------------------------------------------------------------


def _sum_axis(a: GL, axis: int) -> GL:
    """Exact modular sum along `axis` via log-depth halving."""
    return gl.sum_axis0(a if axis == 0 else a.movedim(axis, 0))


def ev_gather_plan(info: StarkInfo):
    """Static plan: group ev_map entries by (section, dim, prime) with the
    felt positions to gather and the ev indices they land in."""
    groups: Dict = {}
    for k, (kind, pid, prime) in enumerate(info.ev_map):
        if kind == "const":
            sec, pos, dim = "const", pid, 1
        else:
            pm = info.cm_pols[info.qs[pid] if kind == "q" else pid]
            sec = pm.section if pm.section == "cm4_2ns" else \
                pm.section.replace("_n", "_2ns")
            pos, dim = pm.section_pos, pm.dim
        groups.setdefault((sec, dim, bool(prime)), []).append((pos, k))
    return groups


def _index(idxs, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idxs, dtype=np.int64), device=device)


def _take_cols(mat: GL, idxs) -> GL:
    return mat.index_select(1, _index(idxs, mat.device))


# The matrix forms of step 5 form each GL3 product of a gathered (rows, K)
# block whole, in eager ops: while gl3.mul's last Karatsuba product is
# formed, the three gathered blocks, five finished products and the twelve
# intermediates of one gl.mul (al, ah, p00..p11, mid, midc, lo, c0, hi and
# the reduction's) are alive, some 24 blocks of rows * K words.  K is the
# widest block whose temporaries fit STEP5_BLOCK_BYTES; at one column a
# block costs what the per-entry form's product does.
STEP5_LIVE_BLOCKS = 24
STEP5_BLOCK_BYTES = 1 << 30


def step5_block_cols(rows: int) -> int:
    """Columns of one gathered block of the matrix forms over `rows` rows."""
    return max(1, STEP5_BLOCK_BYTES // (STEP5_LIVE_BLOCKS * rows * 8))


def step5_evals_matrix(info: StarkInfo, sections: Dict[str, GL],
                       const_2ns: GL, xi: GL3,
                       k_chunk: Optional[int] = None) -> GL3:
    """evmap as weighted column sums: evals[k] = sum_i p_k(x_i) * lev_i.

    The same values as step5_evals (modular sums are exact), one gathered
    (n, K) block per (section, dim, prime) group instead of one product per
    entry.  ``k_chunk`` caps K; by default step5_block_cols(n)."""
    n = info.n
    k_chunk = k_chunk or step5_block_cols(n)
    dev = xi.device
    blow = 1 << info.blowup_bits
    shift_inv = pow(SHIFT, P - 2, P)
    w_n = gl.w(info.n_bits)
    xis = gl3.mul_base(xi, shift_inv)
    wxis = gl3.mul_base(gl3.mul_base(xi, w_n), shift_inv)
    lev = _intt3(gl3.powers_scan(xis, n))
    lpev = _intt3(gl3.powers_scan(wxis, n))

    size_ev = len(info.ev_map)
    out = [torch.zeros((size_ev,), dtype=torch.int64, device=dev)
           for _ in range(3)]
    for (sec, dim, prime), entries in ev_gather_plan(info).items():
        mat = (const_2ns if sec == "const" else sections[sec])[::blow]
        lcoef = lpev if prime else lev
        for c0 in range(0, len(entries), k_chunk):
            part = entries[c0:c0 + k_chunk]
            pos = np.array([p for (p, _k) in part])
            ks = _index([k for (_p, k) in part], dev)
            if dim == 1:
                cols = _take_cols(mat, pos)       # (n, K)
                for c, lc in enumerate(lcoef):
                    out[c][ks] = _sum_axis(gl.mul(cols, lc[:, None]), 0)
            else:
                v = GL3(_take_cols(mat, pos), _take_cols(mat, pos + 1),
                        _take_cols(mat, pos + 2))
                prod = gl3.mul(v, GL3(*(lc[:, None] for lc in lcoef)))
                for c, comp in enumerate(prod):
                    out[c][ks] = _sum_axis(comp, 0)
    return GL3(*out)


def step5_fri_matrix(info: StarkInfo, sections: Dict[str, GL],
                     const_2ns: GL, challenges: GL3, publics: GL,
                     x_2ns: GL, zi: GL, evals: GL3, xi: GL3,
                     k_chunk: Optional[int] = None) -> GL3:
    """FRI polynomial as weighted column sums.

    step52ns terms are (p_k - eval_k) Horner-folded in v1 per (plain,
    primed) subsequence; distributing the fold gives
        F_sub = sum_j v1^(K-1-j) * p_(k_j)  -  sum_j v1^(K-1-j) * eval_(k_j)
    with the first sum a gather + broadcast-mul + log-sum over columns and
    the second a scalar: the same modular values as step5_fri_pol.
    ``k_chunk`` caps a block's columns; by default step5_block_cols(n_ext)."""
    n_ext = info.n_ext
    k_chunk = k_chunk or step5_block_cols(n_ext)
    dev = xi.device
    v1 = challenges[5]
    v2 = challenges[6]
    wxi = gl3.mul_base(xi, gl.w(info.n_bits))
    xdiv = x_div_x_sub(x_2ns, xi)
    xdivw = x_div_x_sub(x_2ns, wxi)

    plan = ev_gather_plan(info)
    plain = [k for k, (_, _, pr) in enumerate(info.ev_map) if not pr]
    primed = [k for k, (_, _, pr) in enumerate(info.ev_map) if pr]
    orders = {False: {k: j for j, k in enumerate(plain)},
              True: {k: j for j, k in enumerate(primed)}}
    counts = {False: len(plain), True: len(primed)}
    # v1 powers, high power first: coeff[k] = v1^(K-1-order[k])
    pows = gl3.powers_scan(v1, max(counts[False], counts[True], 1))

    acc = {False: gl3.zeros((n_ext,), dev), True: gl3.zeros((n_ext,), dev)}
    sub = {False: gl3.zeros((), dev), True: gl3.zeros((), dev)}

    for (sec, dim, prime), entries in plan.items():
        mat = const_2ns if sec == "const" else sections[sec]
        for c0 in range(0, len(entries), k_chunk):
            part = entries[c0:c0 + k_chunk]
            pos = np.array([p for (p, _k) in part])
            ks = _index([k for (_p, k) in part], dev)
            cf = pows[_index([counts[prime] - 1 - orders[prime][k]
                              for (_p, k) in part], dev)]    # (K,) GL3
            # subtracted scalar: sum_k coeff_k * eval_k
            sub[prime] = gl3.add(sub[prime], gl3.sum_axis0(
                gl3.mul(cf, evals[ks])))
            cfb = GL3(*(c[None, :] for c in cf))
            if dim == 1:
                cols = _take_cols(mat, pos)              # (n_ext, K)
                term = GL3(*(_sum_axis(gl.mul(cols, c), 1) for c in cfb))
            else:
                v = GL3(_take_cols(mat, pos), _take_cols(mat, pos + 1),
                        _take_cols(mat, pos + 2))
                term = GL3(*(_sum_axis(c, 1) for c in gl3.mul(v, cfb)))
            acc[prime] = gl3.add(acc[prime], term)

    f_val = gl3.mul(gl3.sub(acc[False], sub[False]), xdiv)
    if primed:
        fw = gl3.mul(gl3.sub(acc[True], sub[True]), gl3.mul(xdivw, v2))
        f_val = gl3.add(f_val, fw)
    return f_val


def step2_vm(info: StarkInfo, vmprog, sections: Dict[str, GL], const_n: GL,
             challenges: GL3, publics: GL, x_n: GL):
    """f/t expressions via the VM; returns exp id -> (n,) GL3."""
    out = vm_mod.run_program(
        vmprog, info, {"cm1_n": sections["cm1_n"], "const": const_n}, info.n,
        challenges=challenges, publics=publics, x=x_n, roll_k=1)
    return {dest[1]: v for dest, v in out.items()}


def step3_vm(info: StarkInfo, vmprog, sections: Dict[str, GL], const_n: GL,
             challenges: GL3, publics: GL, x_n: GL):
    """num/den/im columns via the VM; returns cm id -> (n,) GL3."""
    out = vm_mod.run_program(
        vmprog, info, {"cm1_n": sections["cm1_n"], "cm2_n": sections["cm2_n"],
                       "const": const_n}, info.n,
        challenges=challenges, publics=publics, x=x_n, roll_k=1)
    return {dest[1]: v for dest, v in out.items()}


def step4_vm(info: StarkInfo, vmprog, sections: Dict[str, GL],
             const_2ns: GL, challenges: GL3, publics: GL, x_2ns: GL,
             zi: GL) -> GL:
    """Full quotient via the VM (c_exp as ONE dest: the alpha-Horner
    accumulator folds inside the program, so constraint values die at once
    instead of pinning a register each), then the INTT/split/NTT
    finalize."""
    secs = {k: sections[k] for k in ("cm1_2ns", "cm2_2ns", "cm3_2ns")}
    secs["const"] = const_2ns
    out = vm_mod.run_program(
        vmprog, info, secs, info.n_ext, challenges=challenges,
        publics=publics, x=x_2ns, zi=zi, roll_k=1 << info.blowup_bits)
    return step4_finalize(info, out[("acc", 0)], zi)
