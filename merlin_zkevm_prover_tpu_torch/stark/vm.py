"""Expression-program VM: a step program as data, run by one interpreter.

The counterpart of the reference's scan VM (``stark/vm.py``), itself the
rendering of the bytecode-interpreter ("parser") form of the reference's
generated constraint evaluators (zkevm.chelpers.step3.parser.cpp:11-60):
the zkEVM's step programs (some 30k expression nodes in step 4) become

  * instructions: (opcode, a, b, dst) int32 rows;
  * a (R, 3, n) GL3 register file; linear-scan register allocation
    (structural-hash CSE, last-use recycling) keeps R small; program dests
    are pinned so step outputs survive the run;
  * section columns read in place: a LOAD / LOADR (rotated by ``roll_k``
    rows) reads one column, or three for a GL3 polynomial;
  * scalars (literals, challenge components, publics, evals, and every
    scalar-only subexpression) in a small (L, 3) constant table whose
    derived entries are evaluated once per run on the host, folded into
    ADDC/SUBC/CSUBC/MULC instruction forms.

Everything is GL3 (base values ride with c1 = c2 = 0).  Compilation
(``compile_program``, ``compile_program_ordered``) is host code on python
ints, carried across unchanged but for one fix (``compile_program`` now
asserts what it used to promise).  ``run_program`` runs the code through
``ops.vm_cuda.vm_run``: on a CUDA tensor one launch of the interpreter
kernel (``csrc/vm_gl.cu``), on a CPU tensor its plain twin, a PyTorch loop
over the instructions.  ``run_program_plain`` always takes the plain twin.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops import goldilocks as gl
from ..ops import goldilocks3 as gl3
from ..ops import vm_cuda
from ..ops.goldilocks import GL, P
from ..ops.goldilocks3 import GL3
from ..ops.vm_cuda import (  # noqa: F401  (the opcodes, re-exported)
    ADD, ADDC, CSUBC, LOAD, LOADC, LOADR, MUL, MULC, NEG, SUB, SUBC)
from .air import Expr

_SCALAR_LEAVES = ("challenge", "public", "number", "eval")
_VECTOR_LEAVES = ("x", "Zi", "xDivXSubXi", "xDivXSubWXi")


@dataclass
class VMProgram:
    """Compiled expression program (host-side static data)."""

    n_regs: int
    code: np.ndarray                     # (Ni, 4) int32: opcode, a, b, dst
    # constant table: ('leaf', kind, value-or-id) | ('op', kind, i, j)
    # entries, in evaluation order (derived entries reference earlier ones)
    consts: List[Tuple]
    # vector preloads: (reg, 'x' | 'Zi' | 'xDivXSubXi' | 'xDivXSubWXi')
    preload: List[Tuple[int, str]]
    out_regs: Dict[Tuple, int]           # dest -> register
    sections: List[str]                  # LOAD section index order


def _check_no_pending_reads(items) -> None:
    """``compile_program`` reads every cm leaf from its section: a leaf that
    names an earlier cm dest of the same program would read a column that
    is not written yet.  ``compile_program_ordered`` rewrites such leaves
    onto the dest's expression first."""
    produced: set = set()
    for dest, e in items:
        bad: set = set()
        stack, seen = [e], set()
        while produced and stack:
            x = stack.pop()
            if x in seen:
                continue
            seen.add(x)
            if x.kind == "cm" and x.id in produced:
                bad.add(x.id)
            stack.extend(x.args)
        assert not bad, (
            f"dest {dest}: cm leaves {sorted(bad)} name earlier dests of this "
            "program; compile it with compile_program_ordered")
        if dest[0] == "cm":
            produced.add(dest[1])


def compile_program(
    prog: Sequence[Tuple[Tuple, Expr]],
    info,
    domain: str,
    section_names: List[str],
) -> VMProgram:
    """Lower (dest, Expr) pairs to VM code with structural-hash CSE.

    Every cm leaf is read from its section.  A cm leaf that names an
    earlier dest of this program is refused (AssertionError): use
    ``compile_program_ordered``, which reads such leaves from the dest's
    register (the evaluator's pending_cm semantics)."""
    sec_idx = {s: i for i, s in enumerate(section_names)}

    # ---- structural postorder + refcounts ----
    order: List[Expr] = []
    index: Dict[Expr, int] = {}

    def walk(e: Expr):
        if e in index:
            return
        for a in e.args:
            walk(a)
        index[e] = len(order)
        order.append(e)

    items = list(prog)
    _check_no_pending_reads(items)
    for _dest, e in items:
        walk(e)

    refcount: Dict[Expr, int] = {}
    for e in order:
        for a in e.args:
            refcount[a] = refcount.get(a, 0) + 1
    pinned: set = {e for _d, e in items}

    # ---- scalar classification (const-table candidates) ----
    is_scalar: Dict[Expr, bool] = {}
    for e in order:
        if e.kind in _SCALAR_LEAVES:
            is_scalar[e] = True
        elif e.kind in ("add", "sub", "mul", "neg"):
            is_scalar[e] = all(is_scalar[a] for a in e.args)
        else:
            is_scalar[e] = False

    consts: List[Tuple] = []
    const_at: Dict = {}

    def const_entry(e: Expr) -> int:
        if e in const_at:
            return const_at[e]
        if e.kind in _SCALAR_LEAVES:
            ent = ("leaf", e.kind,
                   e.value if e.kind == "number" else e.id)
        else:
            args = [const_entry(a) for a in e.args]
            ent = ("op", e.kind, args[0],
                   args[1] if len(args) > 1 else -1)
        idx = len(consts)
        consts.append(ent)
        const_at[e] = idx
        return idx

    # ---- register allocation ----
    code: List[Tuple[int, int, int, int]] = []
    node_reg: Dict[Expr, int] = {}
    protected: set = set()               # regs never recycled
    free_regs: List[int] = []
    n_regs = 0
    released: Dict[Expr, int] = {}

    def alloc() -> int:
        nonlocal n_regs
        if free_regs:
            return free_regs.pop()
        r = n_regs
        n_regs += 1
        return r

    def release(a: Expr):
        released[a] = released.get(a, 0) + 1
        if released[a] == refcount.get(a, 0) and a not in pinned:
            r = node_reg.get(a)
            if r is not None and r not in protected:
                free_regs.append(r)

    preload: List[Tuple[int, str]] = []
    preload_at: Dict[str, int] = {}

    def load_instr(e: Expr) -> Tuple[int, int, int]:
        """(opcode, a, b) for a section-column load."""
        if e.kind == "const":
            sec, pos, dim = "const", e.id, 1
        else:
            pid = info.qs[e.id] if e.kind == "q" else e.id
            pm = info.cm_pols[pid]
            sec = pm.section
            if domain == "ext" and sec != "cm4_2ns":
                sec = sec.replace("_n", "_2ns")
            pos, dim = pm.section_pos, pm.dim
        if sec not in sec_idx:
            raise KeyError(
                f"{e.kind}{e.id} lives in section {sec!r} which is not an "
                f"input of this program (pending dest not rewritten?)")
        return (LOADR if e.prime else LOAD, sec_idx[sec], (pos << 2) | dim)

    def resolve(a: Expr) -> Tuple[int, bool]:
        """Operand register for `a`; bool = temp (release after use).

        Section loads are not CSEd into long-lived registers: a column
        shared by distant expressions would pin a (3, n) row for the whole
        run and R would track the ~1900 distinct columns.  Reloading per
        use is one cheap read."""
        if a in node_reg:
            return node_reg[a], False
        if a.kind in _VECTOR_LEAVES:
            return vector_leaf_reg(a), False
        if a.kind in ("cm", "const", "q", "tmpexp"):
            opc, sa, sb = load_instr(a)
            r = alloc()
            code.append((opc, sa, sb, r))
            return r, True
        raise ValueError(a.kind)

    def vector_leaf_reg(e: Expr) -> int:
        if e.kind not in preload_at:
            # preloads are written before the first instruction: they take
            # a fresh register number, never one recycled from an earlier
            # temp (a later write to that slot would clobber them)
            nonlocal n_regs
            r = n_regs
            n_regs += 1
            protected.add(r)
            preload_at[e.kind] = r
            preload.append((r, e.kind))
        return preload_at[e.kind]

    def free_temp(r: int):
        if r not in protected:
            free_regs.append(r)

    for e in order:
        k = e.kind
        if is_scalar[e]:
            continue                      # materializes lazily via C-forms
        if k in _VECTOR_LEAVES or k in ("cm", "const", "q", "tmpexp"):
            continue                      # resolved per use
        if k == "neg":
            (a,) = e.args
            ra, ta = resolve(a)
            r = alloc()
            code.append((NEG, ra, 0, r))
            if ta:
                free_temp(ra)
            else:
                release(a)
            node_reg[e] = r
        elif k in ("add", "sub", "mul"):
            a, b = e.args
            sa, sb = is_scalar[a], is_scalar[b]
            if not sa and not sb:
                ra, ta = resolve(a)
                rb, tb = resolve(b)
                r = alloc()
                opc = {"add": ADD, "sub": SUB, "mul": MUL}[k]
                code.append((opc, ra, rb, r))
                for (rr, tt, aa) in ((ra, ta, a), (rb, tb, b)):
                    if tt:
                        free_temp(rr)
                    else:
                        release(aa)
            elif sb:
                ra, ta = resolve(a)
                r = alloc()
                c = const_entry(b)
                opc = {"add": ADDC, "sub": SUBC, "mul": MULC}[k]
                code.append((opc, ra, c, r))
                if ta:
                    free_temp(ra)
                else:
                    release(a)
            else:  # sa and not sb
                rb, tb = resolve(b)
                r = alloc()
                c = const_entry(a)
                if k == "sub":
                    code.append((CSUBC, rb, c, r))
                else:
                    opc = {"add": ADDC, "mul": MULC}[k]
                    code.append((opc, rb, c, r))
                if tb:
                    free_temp(rb)
                else:
                    release(b)
            node_reg[e] = r
        else:
            raise ValueError(k)

    # pin + register outputs (scalar dests get a LOADC materialization;
    # bare-column dests get their own LOAD)
    out_regs: Dict[Tuple, int] = {}
    for dest, e in items:
        if e not in node_reg:
            if is_scalar[e]:
                r = alloc()
                code.append((LOADC, const_entry(e), 0, r))
            else:
                r, _tmp = resolve(e)
            node_reg[e] = r
        r = node_reg[e]
        protected.add(r)
        out_regs[dest] = r

    return VMProgram(
        n_regs=n_regs,
        code=np.array(code, dtype=np.int32).reshape(-1, 4),
        consts=consts,
        preload=preload,
        out_regs=out_regs,
        sections=list(section_names),
    )


def compile_program_ordered(
    prog: Sequence[Tuple[Tuple, Expr]],
    info,
    domain: str,
    section_names: List[str],
) -> VMProgram:
    """Order-aware variant: dest i's register is visible to items > i
    (pending-cm semantics).  Implemented by rewriting later items' cm
    leaves onto the dest expressions before one-shot compilation —
    structural CSE then collapses the reads onto the dest's register."""
    produced: Dict[int, Expr] = {}
    rewritten: List[Tuple[Tuple, Expr]] = []
    memo: Dict[Expr, Expr] = {}

    def subst(e: Expr) -> Expr:
        if e.kind == "cm" and e.id in produced and not e.prime:
            return produced[e.id]
        if not e.args:
            return e
        hit = memo.get(e)
        if hit is not None:
            return hit
        out = Expr(e.kind, id=e.id, prime=e.prime, value=e.value,
                   args=tuple(subst(a) for a in e.args))
        memo[e] = out
        return out

    for dest, e in prog:
        e2 = subst(e)
        rewritten.append((dest, e2))
        if dest[0] == "cm":
            produced[dest[1]] = e2
            memo = {}
    return compile_program(rewritten, info, domain, section_names)


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------


def _host_words(v) -> Optional[List]:
    """A GL / GL3 tensor (any shape) -> nested python ints, or None."""
    if v is None:
        return None
    if isinstance(v, GL3):
        return gl3.to_u64(v).tolist()
    return gl.to_u64(v).tolist()


def build_const_table(vm: VMProgram, challenges: Optional[GL3],
                      publics: Optional[GL], evals: Optional[GL3]) -> np.ndarray:
    """(L, 3) uint64 scalar table, at least one row, evaluated in order on
    the host in python ints (L is tens to hundreds)."""
    ch, pub, ev = (_host_words(v) for v in (challenges, publics, evals))
    rows: List[Tuple[int, int, int]] = []
    for ent in vm.consts:
        if ent[0] == "leaf":
            _tag, kind, idv = ent
            if kind == "number":
                v = (idv % P, 0, 0)
            elif kind == "challenge":
                v = tuple(ch[idv])
            elif kind == "public":
                v = (pub[idv], 0, 0)
            else:  # eval
                v = tuple(ev[idv])
        else:
            _tag, kind, i, j = ent
            a = rows[i]
            if kind == "neg":
                v = tuple((-x) % P for x in a)
            elif kind == "add":
                v = tuple((x + y) % P for x, y in zip(a, rows[j]))
            elif kind == "sub":
                v = tuple((x - y) % P for x, y in zip(a, rows[j]))
            else:  # mul
                v = gl3._host_gl3_mul(a, rows[j])
        rows.append(v)
    if not rows:
        return np.zeros((1, 3), dtype=np.uint64)
    return np.array(rows, dtype=np.uint64)


def _launch_inputs(vm: VMProgram, sections: Dict[str, GL], n: int,
                   challenges, publics, x, zi, evals, x_div_x_sub_xi,
                   x_div_x_sub_wxi):
    """The interpreter's operands: the code, and on the sections' device the
    constant table, the sections in ``vm.sections`` order and the
    preloads."""
    dev = sections[vm.sections[0]].device
    for s in vm.sections:
        if sections[s].shape[0] != n:
            raise ValueError(f"section {s}: {sections[s].shape[0]} rows, "
                             f"expected {n}")
    table = gl.from_u64(build_const_table(vm, challenges, publics, evals), dev)
    vec = {"x": x, "Zi": zi, "xDivXSubXi": x_div_x_sub_xi,
           "xDivXSubWXi": x_div_x_sub_wxi}
    preloads = []
    for r, kind in vm.preload:
        v = vec[kind]
        if not isinstance(v, GL3):
            v = gl3.from_base(v)
        preloads.append((r, gl3.broadcast_to(v, (n,))))
    return vm.code, table, [sections[s] for s in vm.sections], preloads


def _run(run_fn, vm: VMProgram, sections, n, challenges, publics, x, zi,
         evals, x_div_x_sub_xi, x_div_x_sub_wxi, roll_k):
    code, table, secs, preloads = _launch_inputs(
        vm, sections, n, challenges, publics, x, zi, evals, x_div_x_sub_xi,
        x_div_x_sub_wxi)
    dests = list(vm.out_regs)
    outs = run_fn(code, table, secs, preloads, [vm.out_regs[d] for d in dests],
                  vm.n_regs, n, roll_k)
    return {d: GL3(o[0], o[1], o[2]) for d, o in zip(dests, outs)}


def run_program(
    vm: VMProgram,
    info,
    sections: Dict[str, GL],             # (n, W) matrices, as stored
    n: int,
    challenges: Optional[GL3] = None,
    publics: Optional[GL] = None,
    x: Optional[GL] = None,
    zi: Optional[GL] = None,
    evals: Optional[GL3] = None,
    x_div_x_sub_xi: Optional[GL3] = None,
    x_div_x_sub_wxi: Optional[GL3] = None,
    roll_k: int = 1,
) -> Dict[Tuple, GL3]:
    """Execute; returns dest -> (n,) GL3 values.  On CUDA tensors one
    launch of the interpreter kernel."""
    return _run(vm_cuda.vm_run, vm, sections, n, challenges, publics, x, zi,
                evals, x_div_x_sub_xi, x_div_x_sub_wxi, roll_k)


def run_program_plain(
    vm: VMProgram,
    info,
    sections: Dict[str, GL],
    n: int,
    challenges: Optional[GL3] = None,
    publics: Optional[GL] = None,
    x: Optional[GL] = None,
    zi: Optional[GL] = None,
    evals: Optional[GL3] = None,
    x_div_x_sub_xi: Optional[GL3] = None,
    x_div_x_sub_wxi: Optional[GL3] = None,
    roll_k: int = 1,
) -> Dict[Tuple, GL3]:
    """``run_program`` through the plain PyTorch interpreter on any
    device."""
    return _run(vm_cuda.vm_run_plain, vm, sections, n, challenges, publics, x,
                zi, evals, x_div_x_sub_xi, x_div_x_sub_wxi, roll_k)
