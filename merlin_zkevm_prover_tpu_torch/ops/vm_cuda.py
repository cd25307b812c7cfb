"""The expression-program interpreter on the GPU, and its plain twin.

``vm_run`` runs a compiled step program (``stark/vm.py``) over every row of
its domain in one launch of ``vm_run_kernel`` (``csrc/vm_gl.cu``).  It has
no Pallas counterpart: the reference runs its VM as one ``lax.scan`` over
the instructions (``stark/vm.py:532``), whose body XLA compiles once; this
kernel is the port's form of that compiled body, so that a program of tens
of thousands of instructions costs one launch and not millions of PyTorch
elementwise launches.

Before a launch the wrapper rewrites the code it launches with (never the
program ``compile_program`` emits):

* a typing pass (``_layout``) follows which values are base values
  (c1 = c2 = 0) from the code alone: a LOAD / LOADR with ``dim != 3`` gives
  one, and so does an ADD, SUB, MUL or NEG of base values; constants,
  LOADC and preloads count as extension values.  It sets the flags
  ``A_BASE`` / ``B_BASE`` (read that operand as ``(c0, 0, 0)``) and
  ``D_BASE`` (the result is base: write c0 alone) in the opcode word, so a
  base x base MUL is one 64-bit product and a base x extension one three;
* the same pass allocates registers anew, value by value: a base value
  takes a one-word slot, an extension value a three-word slot, and a slot
  is free again after its value's last read; slots are numbered by use,
  most used first;
* ``_vm_plan`` picks the rows of a block from the file's size, so that the
  file sits in shared memory with room for 16 warps an SM; registers past
  that budget spill to device memory in the same kernel (more warps beat
  fewer spilled words, as measured);
* ``_kernel_code`` turns slots into offsets in the shared file and brings
  a spilled register in and out through a temporary (FILL and SPILL
  instructions).

Each thread runs ``VM_ROWS_PER_THREAD`` rows (one: measured best, PERF.md).
Sections are read in place.  The kernel writes only the output registers,
to an ``(n_out, 3, n)`` tensor; no ``(R, 3, n)`` register file is allocated
unless registers spill, and then only the spilled words.  GL3 arithmetic is
``goldilocks.cuh``'s canonical ``gl3_*`` helpers.

``vm_run_plain`` is the same function as a PyTorch loop over the
instructions; it takes the code as given, flags or none (the flags mean the
same there).  ``vm_run`` takes it only for a CPU tensor; on a CUDA tensor it
launches the kernel or raises.  ``LAUNCHES["vm_run"]`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import cuda_build
from . import goldilocks as gl
from . import goldilocks3 as gl3
from .goldilocks import GL
from .goldilocks3 import GL3

# opcodes (order matters: both interpreters switch on these numbers)
(ADD, SUB, MUL, ADDC, SUBC, CSUBC, MULC, NEG, LOAD, LOADR, LOADC) = range(11)
N_OPCODES = 11
FILL, SPILL = 11, 12   # the kernel's own: a spilled register in and out
TEMP_WORDS = 6         # two extension registers on chip for FILL / SPILL
# flags in the opcode word (VM_OP_MASK, VM_A_BASE, ... of csrc/vm_gl.cu)
OP_MASK, A_BASE, B_BASE, D_BASE = 15, 16, 32, 64

MAX_SECTIONS = 8   # VM_MAX_SECTIONS of csrc/vm_gl.cu
MAX_PRELOADS = 4   # VM_MAX_PRELOADS: x, Zi, xDivXSubXi, xDivXSubWXi
SMEM_BLOCK_MAX = 232_448      # VM_SMEM_MAX: shared bytes a block may use
SMEM_SM = 233_472             # shared bytes of one SM (228 KB) ...
SMEM_BLOCK_RESERVED = 1_024   # ... of which the runtime keeps this a block
WARPS_PER_SM = 16             # the plan's aim (tools/vm_times.py --budget)

LAUNCHES = {"vm_run": 0}


class _VmArgs(ctypes.Structure):
    """``struct VmArgs`` of ``csrc/vm_gl.cu``, field for field."""
    _ll = ctypes.c_longlong
    _fields_ = [("code", ctypes.c_void_p), ("n_instr", _ll),
                ("table", ctypes.c_void_p),
                ("sec", ctypes.c_void_p * MAX_SECTIONS),
                ("sec_rs", _ll * MAX_SECTIONS), ("sec_cs", _ll * MAX_SECTIONS),
                ("n_secs", _ll),
                ("pre", ctypes.c_void_p * (3 * MAX_PRELOADS)),
                ("pre_stride", _ll * (3 * MAX_PRELOADS)),
                ("pre_word", _ll * MAX_PRELOADS), ("n_pre", _ll),
                ("outs", ctypes.c_void_p), ("n_out", _ll),
                ("out", ctypes.c_void_p), ("spill", ctypes.c_void_p),
                ("n_words", _ll), ("slots_on", _ll), ("rows", _ll),
                ("n", _ll), ("n_pad", _ll), ("roll_k", _ll)]


_DEFINES: Dict[Tuple[str, str], int] = {}


def _define(name: str) -> int:
    """A ``#define`` of the kernel source the library is built from."""
    src = cuda_build.CSRC / "vm_gl.cu"
    key = (str(src), name)
    if key not in _DEFINES:
        m = re.search(rf"^#define {name} (\d+)", src.read_text(), flags=re.M)
        if m is None:
            raise RuntimeError(f"vm: no #define {name} in {src}")
        _DEFINES[key] = int(m.group(1))
    return _DEFINES[key]


def _check_code(code: np.ndarray, n_regs: int, n_consts: int,
                widths: Sequence[int]) -> None:
    """Every operand of every instruction in range: registers, constant
    rows, sections and the columns a load reads.  The opcode word may
    carry the base-field flags."""
    if code.ndim != 2 or code.shape[1] != 4:
        raise ValueError(f"vm: expected (Ni, 4) code, got {code.shape}")
    if not len(code):
        return
    word, a, b, dst = (code[:, k].astype(np.int64) for k in range(4))
    op = word & OP_MASK
    if ((word < 0) | (word > OP_MASK | A_BASE | B_BASE | D_BASE)
            | (op >= N_OPCODES)).any():
        raise ValueError("vm: unknown opcode")
    if ((dst < 0) | (dst >= n_regs)).any():
        raise ValueError("vm: destination register out of range")
    reads_a = op <= NEG
    reads_b = op <= MUL
    const_b = (op >= ADDC) & (op <= MULC)
    if ((reads_a & ((a < 0) | (a >= n_regs))).any()
            or (reads_b & ((b < 0) | (b >= n_regs))).any()):
        raise ValueError("vm: operand register out of range")
    if ((const_b & ((b < 0) | (b >= n_consts))).any()
            or ((op == LOADC) & ((a < 0) | (a >= n_consts))).any()):
        raise ValueError("vm: constant row out of range")
    load = (op == LOAD) | (op == LOADR)
    if (load & ((a < 0) | (a >= len(widths)))).any():
        raise ValueError("vm: section out of range")
    w = np.asarray(list(widths) + [0], dtype=np.int64)[np.where(load, a, -1)]
    end = (b >> 2) + np.where((b & 3) == 3, 3, 1)
    if (load & ((b < 0) | (end > w))).any():
        raise ValueError("vm: load past the end of its section")


def _checked(code: np.ndarray, table: GL, sections: Sequence[GL],
             preloads: Sequence[Tuple[int, GL3]], out_regs: Sequence[int],
             n_regs: int, n: int):
    """The checks both interpreters make: the code as contiguous int32, each
    section with its row and column strides in words, each preload register
    with its three component vectors and their strides."""
    dev = table.device
    code = np.ascontiguousarray(code, dtype=np.int32)
    if table.dtype != torch.int64 or table.ndim != 2 or table.shape[1] != 3:
        raise ValueError("vm: expected an (L, 3) int64 constant table")
    if len(sections) > MAX_SECTIONS or len(preloads) > MAX_PRELOADS:
        raise ValueError("vm: too many sections or preloads")
    if n < 1 or n_regs < 0:
        raise ValueError("vm: empty domain or negative register count")
    secs = []
    for s in sections:
        if s.dtype != torch.int64 or s.ndim != 2 or s.shape[0] != n \
                or s.device != dev:
            raise ValueError("vm: sections must be (n, W) int64 on the "
                             "table's device")
        secs.append((s, s.stride(0), s.stride(1)))
    pre = []
    for r, v in preloads:
        if not 0 <= r < n_regs:
            raise ValueError("vm: preload register out of range")
        for c in v:
            if c.dtype != torch.int64 or c.shape != (n,) or c.device != dev:
                raise ValueError("vm: preloads must be (n,) int64 on the "
                                 "table's device")
        pre.append((r, [(c, c.stride(0)) for c in v]))
    if any(not 0 <= r < n_regs for r in out_regs):
        raise ValueError("vm: output register out of range")
    _check_code(code, n_regs, table.shape[0], [s.shape[1] for s in sections])
    return code, secs, pre


def _remap(code: np.ndarray, table) -> np.ndarray:
    """`code` with every register operand r (a of the instructions that
    read a register, b of ADD, SUB and MUL, dst) replaced by table[r]."""
    out = code.copy()
    if len(code):
        op = code[:, 0] & OP_MASK
        tab = np.append(np.asarray(table, dtype=np.int64), 0)
        out[:, 1] = np.where(op <= NEG, tab[np.where(op <= NEG, code[:, 1], -1)],
                             code[:, 1])
        out[:, 2] = np.where(op <= MUL, tab[np.where(op <= MUL, code[:, 2], -1)],
                             code[:, 2])
        out[:, 3] = tab[code[:, 3]]
    return out


_LAYOUTS: Dict[tuple, dict] = {}
_LAYOUTS_KEPT = 16


def _layout(code: np.ndarray, n_regs: int, pre_regs: Sequence[int],
            out_regs: Sequence[int]) -> dict:
    """The typing pass and a new register allocation, for checked `code`
    (any flags it carries are recomputed).  Every write starts a value;
    base values (c1 = c2 = 0 by the code alone) get one-word slots,
    extension values three-word slots; a slot is free again after its
    value's last read.  Registers start as base values (0), preloads as
    extension values.  Slots are numbered by use, most used first.

    ``code``     the program over slots, flags set: the same function as
                 `code` (the plain interpreter runs it with ``slots``
                 registers, the preloads in ``pre`` and the outputs in
                 ``out``);
    ``widths``   words of each slot (1 or 3); slot s starts at word
                 ``sum(widths[:s])``;
    ``pre``      the slot of each preload register, in `pre_regs` order;
    ``out``      (slot, holds a base value) of each output register.

    Kept for the last few programs: a proof runs the same three."""
    key = (code.tobytes(), n_regs, tuple(pre_regs), tuple(out_regs))
    if key in _LAYOUTS:
        return _LAYOUTS[key]
    rows = code.tolist()
    end = len(rows)                  # "read after the last instruction"
    is_base, last = [], []           # by value

    def value(base: bool) -> int:
        is_base.append(base)
        last.append(-1)
        return len(is_base) - 1

    cur = [value(True) for _ in range(n_regs)]
    for r in pre_regs:
        is_base[cur[r]] = False
    init = list(cur)
    prog = []                        # (op | flags, value a, value b, dst)
    for k, (w, a, b, d) in enumerate(rows):
        op = w & OP_MASK
        va = cur[a] if op <= NEG else None
        vb = cur[b] if op <= MUL else None
        f = 0
        if va is not None:
            last[va] = k
            f |= A_BASE if is_base[va] else 0
        if vb is not None:
            last[vb] = k
            f |= B_BASE if is_base[vb] else 0
        if op <= MUL:
            res = is_base[va] and is_base[vb]
        elif op == NEG:
            res = is_base[va]
        elif op in (LOAD, LOADR):
            res = (b & 3) != 3
        else:
            res = False
        cur[d] = value(res)
        prog.append((op | f | (D_BASE if res else 0), va, vb, cur[d], a, b))
    for r in out_regs:
        last[cur[r]] = end

    slot = [-1] * len(is_base)
    widths: List[int] = []
    free: Dict[int, List[int]] = {1: [], 3: []}

    def alloc(v: int) -> None:
        w = 1 if is_base[v] else 3
        if free[w]:
            slot[v] = free[w].pop()
        else:
            slot[v] = len(widths)
            widths.append(w)

    def release(v: int) -> None:
        free[1 if is_base[v] else 3].append(slot[v])

    pre = set(pre_regs)
    for r in range(n_regs):          # live at the start: read, output, preload
        if last[init[r]] >= 0 or r in pre:
            alloc(init[r])
    for r in pre:
        if last[init[r]] < 0:
            release(init[r])
    out_code = []
    for k, (w, va, vb, vd, a, b) in enumerate(prog):
        sa = slot[va] if va is not None else a
        sb = slot[vb] if vb is not None else b
        for v in {va, vb} - {None}:
            if last[v] == k:
                release(v)
        alloc(vd)
        if last[vd] < 0:             # written, never read
            release(vd)
        out_code.append((w, sa, sb, slot[vd]))

    # number slots by use, most used first (these stay on chip when the
    # file spills)
    n_slots = len(widths)
    uses = [0] * n_slots
    for w, sa, sb, sd in out_code:
        op = w & OP_MASK
        uses[sd] += 1
        if op <= NEG:
            uses[sa] += 1
        if op <= MUL:
            uses[sb] += 1
    order = sorted(range(n_slots), key=lambda s: (-uses[s], s))
    renum = [0] * n_slots
    for i, s in enumerate(order):
        renum[s] = i
    widths = [widths[s] for s in order]
    first = np.cumsum([0] + widths)[:-1].astype(np.int32)
    typed = _remap(np.array(out_code, dtype=np.int32).reshape(-1, 4), renum)
    lay = dict(code=typed, widths=widths, first=first,
               pre=[renum[slot[init[r]]] for r in pre_regs],
               out=[(renum[slot[cur[r]]], is_base[cur[r]]) for r in out_regs])
    if len(_LAYOUTS) >= _LAYOUTS_KEPT:
        _LAYOUTS.pop(next(iter(_LAYOUTS)))
    _LAYOUTS[key] = lay
    return lay


def _vm_plan(widths: Sequence[int], n: int,
             budget: int = SMEM_BLOCK_MAX) -> dict:
    """The launch shape of one run over n rows of a register file whose
    registers take `widths` words a row each (in word order):

    ``rows``        rows of a block: VM_ROWS_PER_THREAD times its threads,
                    a multiple of 32 of them, at most VM_MAX_THREADS;
    ``threads``, ``blocks``, ``n_pad`` (= blocks * rows);
    ``regs_on``     the registers in shared memory (a prefix of the word
                    order); the rest spill to device memory;
    ``slots_on``    words a row in shared memory: the registers on chip
                    and, when some spill, TEMP_WORDS for FILL and SPILL;
    ``words``       words a row in all (``slots_on`` and the spilled ones);
    ``smem_bytes``  the block's dynamic shared memory.

    The kernel waits on latency, so warps an SM come first: a block may
    take the shared bytes that leave room for WARPS_PER_SM warps an SM
    (and no more than `budget`).  Rows: the most (up to what n needs)
    whose whole file fits that; else the fewest, with as many registers on
    chip as fit beside the temporaries."""
    rpt, max_threads = _define("VM_ROWS_PER_THREAD"), _define("VM_MAX_THREADS")
    words = sum(widths)
    cands = []
    threads = max_threads
    while threads >= 32:
        if threads == 32 or rpt * threads // 2 < n:
            cands.append(rpt * threads)
        threads //= 2

    def cap(rows: int) -> int:
        blocks = max(1, WARPS_PER_SM * 32 * rpt // rows)
        return min(budget, SMEM_BLOCK_MAX,
                   SMEM_SM // blocks - SMEM_BLOCK_RESERVED)

    fit = [r for r in cands if 8 * words * r <= cap(r)]
    if fit:
        rows, regs_on, slots_on = fit[0], len(widths), words
    else:
        rows, regs_on, slots_on = cands[-1], 0, TEMP_WORDS
        if 8 * slots_on * rows > cap(rows):
            raise ValueError("vm: the shared-memory budget holds no "
                             "temporaries")
        while regs_on < len(widths) and \
                8 * (slots_on + widths[regs_on]) * rows <= cap(rows):
            slots_on += widths[regs_on]
            regs_on += 1
    blocks = -(-n // rows)
    return dict(rows=rows, threads=rows // rpt, blocks=blocks,
                n_pad=blocks * rows,
                words=slots_on + sum(widths[regs_on:]), regs_on=regs_on,
                slots_on=slots_on, smem_bytes=8 * slots_on * rows)


def _kernel_code(lay: dict, plan: dict):
    """The code the kernel runs for layout `lay` (``_layout``) under
    `plan`: register operands become offsets into the shared file (first
    word * rows); a spilled operand is first brought into a temporary by a
    FILL (a: its spilled word), a spilled destination written to one and
    sent out by a SPILL (dst: its spilled word).  Returns the code and the
    location of each slot's first word for the prologue and the epilogue
    (shared words first, then the spilled ones)."""
    widths, first, rows = lay["widths"], lay["first"], plan["rows"]
    on = plan["regs_on"]
    reg_words = int(sum(widths[:on]))
    loc = [int(first[s]) if s < on
           else plan["slots_on"] + int(first[s]) - reg_words
           for s in range(len(widths))]
    code = lay["code"]
    if on == len(widths):
        return _remap(code, first * rows), loc
    tmp_a, tmp_b = reg_words * rows, (reg_words + 3) * rows
    rows_out = []
    for w, a, b, d in code.tolist():
        op = w & OP_MASK
        if op <= NEG:
            if a >= on:
                rows_out.append((FILL | (D_BASE if w & A_BASE else 0),
                                 loc[a] - plan["slots_on"], 0, tmp_a))
                a_off = tmp_a
            else:
                a_off = int(first[a]) * rows
        if op <= MUL:
            if b == a and op <= NEG:
                b_off = a_off
            elif b >= on:
                rows_out.append((FILL | (D_BASE if w & B_BASE else 0),
                                 loc[b] - plan["slots_on"], 0, tmp_b))
                b_off = tmp_b
            else:
                b_off = int(first[b]) * rows
        x = a_off if op <= NEG else a
        y = b_off if op <= MUL else b
        if d >= on:
            rows_out.append((w, x, y, tmp_a))
            rows_out.append((SPILL | (w & D_BASE), tmp_a, 0,
                             loc[d] - plan["slots_on"]))
        else:
            rows_out.append((w, x, y, int(first[d]) * rows))
    return np.array(rows_out, dtype=np.int32).reshape(-1, 4), loc


def _vm_fields(code: np.ndarray, table: GL, sections: Sequence[GL],
               preloads: Sequence[Tuple[int, GL3]], out_regs: Sequence[int],
               n_regs: int, n: int, roll_k: int,
               budget: int = SMEM_BLOCK_MAX) -> dict:
    """Every argument of one launch, tensors in place of their pointers:
    the kernel's code (``_layout``, ``_kernel_code``) with the output
    registers' words after it, on the device; the constant table; each
    section with its row and column strides in words; each preload
    register's first word with its three component vectors and their
    strides; the output tensor (n_out, 3, n); the spilled words (W', n_pad),
    empty when every register fits on chip; the plan (``_vm_plan``, with
    the shared-memory `budget`); the domain size and the rotation of LOADR
    (``roll_k`` mod n).  The checks are the kernel's: it takes nothing they
    refuse."""
    dev = table.device
    code, secs, pre = _checked(code, table, sections, preloads, out_regs,
                               n_regs, n)
    lay = _layout(code, n_regs, [r for r, _ in pre], out_regs)
    plan = _vm_plan(lay["widths"], n, budget)
    kcode, loc = _kernel_code(lay, plan)
    outs = np.array([(loc[s], base) for s, base in lay["out"]],
                    dtype=np.int32).reshape(-1, 2)
    prog = np.concatenate([kcode.ravel(), np.zeros(4, np.int32),
                           outs.ravel()])
    launch = bool(len(code) or pre)
    return dict(code=torch.from_numpy(prog).to(dev), n_instr=len(kcode),
                table=table.contiguous(), secs=secs,
                pre=[(loc[s], comps) for s, (_r, comps) in zip(lay["pre"], pre)],
                n_out=len(out_regs),
                out=(torch.empty if launch else torch.zeros)(
                    (len(out_regs), 3, n), dtype=torch.int64, device=dev),
                spill=torch.empty((plan["words"] - plan["slots_on"],
                                   plan["n_pad"]), dtype=torch.int64,
                                  device=dev),
                plan=plan, n_regs=n_regs, n=n, roll_k=roll_k % n,
                out_regs=list(out_regs))


def _launch(f: dict) -> int:
    """One launch of vm_run_kernel on the fields `f`; returns
    cudaGetLastError()."""
    dev = f["out"].device
    if dev.type != "cuda":
        raise RuntimeError(f"vm_run: unsupported device {dev}")
    plan, code = f["plan"], f["code"]
    a = _VmArgs(code=code.data_ptr(), n_instr=f["n_instr"],
                table=f["table"].data_ptr(), n_secs=len(f["secs"]),
                n_pre=len(f["pre"]),
                outs=code.data_ptr() + 16 * (f["n_instr"] + 1),
                n_out=f["n_out"], out=f["out"].data_ptr(),
                spill=f["spill"].data_ptr(), n_words=plan["words"],
                slots_on=plan["slots_on"], rows=plan["rows"], n=f["n"],
                n_pad=plan["n_pad"], roll_k=f["roll_k"])
    for i, (s, rs, cs) in enumerate(f["secs"]):
        a.sec[i], a.sec_rs[i], a.sec_cs[i] = s.data_ptr(), rs, cs
    for i, (word, comps) in enumerate(f["pre"]):
        a.pre_word[i] = word
        for c, (t, st) in enumerate(comps):
            a.pre[3 * i + c], a.pre_stride[3 * i + c] = t.data_ptr(), st
    with torch.cuda.device(dev):
        return cuda_build.lib().merlin_vm_run(ctypes.addressof(a),
                                              cuda_build.stream_ptr())


def _outputs(f: dict) -> List[GL]:
    return list(f["out"].unbind(0))


def vm_run_plain(code: np.ndarray, table: GL, sections: Sequence[GL],
                 preloads: Sequence[Tuple[int, GL3]], out_regs: Sequence[int],
                 n_regs: int, n: int, roll_k: int) -> List[GL]:
    """Plain PyTorch interpreter, same contract as :func:`vm_run`.  It runs
    the code as given; where the opcode words carry flags, an A_BASE /
    B_BASE operand is read as (c0, 0, 0), a D_BASE result writes c0 alone,
    and an output register whose last write was D_BASE reads (c0, 0, 0)."""
    code, secs, pre = _checked(code, table, sections, preloads, out_regs,
                               n_regs, n)
    k = roll_k % n
    dev = table.device
    regs = torch.zeros((n_regs, 3, n), dtype=torch.int64, device=dev)
    zero = torch.zeros((n,), dtype=torch.int64, device=dev)
    base = [False] * n_regs
    for r, comps in pre:
        for c, (t, _st) in enumerate(comps):
            regs[r, c] = gl.canon(t)
    tab = table.contiguous()

    def reg(r: int, is_base: int) -> GL3:
        if is_base:
            return GL3(regs[r, 0], zero, zero)
        return GL3(regs[r, 0], regs[r, 1], regs[r, 2])

    def const(c: int) -> GL3:
        return GL3(tab[c, 0], tab[c, 1], tab[c, 2])

    def load(s: int, poscode: int, rotate: bool) -> GL3:
        m = secs[s][0]
        pos, dim = poscode >> 2, poscode & 3
        cols = [gl.canon(m[:, pos + j]) for j in range(3 if dim == 3 else 1)]
        if rotate:
            cols = [torch.roll(c, -k) for c in cols]
        while len(cols) < 3:
            cols.append(torch.zeros_like(cols[0]))
        return GL3(*cols)

    for word, a, b, dst in code.tolist():
        op, ab, bb = word & OP_MASK, word & A_BASE, word & B_BASE
        if op == ADD:
            v = gl3.add(reg(a, ab), reg(b, bb))
        elif op == SUB:
            v = gl3.sub(reg(a, ab), reg(b, bb))
        elif op == MUL:
            v = gl3.mul(reg(a, ab), reg(b, bb))
        elif op == ADDC:
            v = gl3.add(reg(a, ab), const(b))
        elif op == SUBC:
            v = gl3.sub(reg(a, ab), const(b))
        elif op == CSUBC:
            v = gl3.sub(gl3.broadcast_to(const(b), (n,)), reg(a, ab))
        elif op == MULC:
            v = gl3.mul(reg(a, ab), const(b))
        elif op == NEG:
            v = gl3.neg(reg(a, ab))
        elif op in (LOAD, LOADR):
            v = load(a, b, op == LOADR)
        else:  # LOADC
            v = const(a)
        # every operand is read above, before dst is written (dst may be a
        # or b after register recycling)
        base[dst] = bool(word & D_BASE)
        if base[dst]:
            regs[dst, 0] = v.c0
        else:
            regs[dst, 0], regs[dst, 1], regs[dst, 2] = v
    return [torch.stack((regs[r, 0], zero, zero)) if base[r] else regs[r]
            for r in out_regs]


def vm_run(code: np.ndarray, table: GL, sections: Sequence[GL],
           preloads: Sequence[Tuple[int, GL3]], out_regs: Sequence[int],
           n_regs: int, n: int, roll_k: int) -> List[GL]:
    """Run the (Ni, 4) int32 program `code` over n rows: registers start at
    0 but for the preloads ``(reg, GL3 of (n,) vectors)``; LOAD reads the
    columns of ``sections[a]`` at row i, LOADR at row (i + roll_k) mod n;
    constants are rows of the (L, 3) `table`.  Words read from sections and
    preloads may be any word (read modulo p).  Returns the (3, n) rows of
    the register file at `out_regs`, canonical."""
    if table.device.type == "cpu":
        return vm_run_plain(code, table, sections, preloads, out_regs, n_regs,
                            n, roll_k)
    f = _vm_fields(code, table, sections, preloads, out_regs, n_regs, n, roll_k)
    if f["n_instr"] or f["pre"]:
        rc = _launch(f)
        LAUNCHES["vm_run"] += 1
        cuda_build.check(rc, "vm_run launch")
    return _outputs(f)
