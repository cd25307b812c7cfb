"""The expression-program interpreter on the GPU, and its plain twin.

``vm_run`` runs a compiled step program (``stark/vm.py``) over every row of
its domain in one launch of ``vm_run_kernel`` (``csrc/vm_gl.cu``).  It has
no Pallas counterpart: the reference runs its VM as one ``lax.scan`` over
the instructions (``stark/vm.py:532``), whose body XLA compiles once; this
kernel is the port's form of that compiled body, so that a program of tens
of thousands of instructions costs one launch and not millions of PyTorch
elementwise launches.

One thread per row runs every instruction in order.  The code (Ni, 4) and
the (L, 3) constant table are read by every thread of a warp at the same
address (broadcast loads); the register file is in device memory, laid out
(R, 3, n), so every register read and write of a warp is coalesced; the
sections are read in place as the port stores them ((n, W), any strides).
GL3 arithmetic is ``goldilocks.cuh``'s canonical ``gl3_*`` helpers.

What bounds it: by the function, the sections' words the program loads
and its outputs, once each, and the GL3 products; by this design, the
register traffic (some 48 bytes a row per two-operand instruction) and the
strided section reads.  Registers kept on chip, sections read transposed
and several rows a thread are later work (``ROADMAP.md``).

``vm_run_plain`` is the same function as a PyTorch loop over the
instructions.  ``vm_run`` takes it only for a CPU tensor; on a CUDA tensor
it launches the kernel or raises.  ``LAUNCHES["vm_run"]`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

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

MAX_SECTIONS = 8   # VM_MAX_SECTIONS of csrc/vm_gl.cu
MAX_PRELOADS = 4   # VM_MAX_PRELOADS: x, Zi, xDivXSubXi, xDivXSubWXi

LAUNCHES = {"vm_run": 0}


class _VmArgs(ctypes.Structure):
    """``struct VmArgs`` of ``csrc/vm_gl.cu``, field for field."""
    _fields_ = [("code", ctypes.c_void_p), ("n_instr", ctypes.c_longlong),
                ("table", ctypes.c_void_p),
                ("sec", ctypes.c_void_p * MAX_SECTIONS),
                ("sec_rs", ctypes.c_longlong * MAX_SECTIONS),
                ("sec_cs", ctypes.c_longlong * MAX_SECTIONS),
                ("n_secs", ctypes.c_longlong),
                ("pre", ctypes.c_void_p * (3 * MAX_PRELOADS)),
                ("pre_stride", ctypes.c_longlong * (3 * MAX_PRELOADS)),
                ("pre_reg", ctypes.c_longlong * MAX_PRELOADS),
                ("n_pre", ctypes.c_longlong),
                ("regs", ctypes.c_void_p), ("n_regs", ctypes.c_longlong),
                ("n", ctypes.c_longlong), ("roll_k", ctypes.c_longlong)]


def _check_code(code: np.ndarray, n_regs: int, n_consts: int,
                widths: Sequence[int]) -> None:
    """Every operand of every instruction in range: registers, constant
    rows, sections and the columns a load reads."""
    if code.ndim != 2 or code.shape[1] != 4:
        raise ValueError(f"vm: expected (Ni, 4) code, got {code.shape}")
    if not len(code):
        return
    op, a, b, dst = (code[:, k].astype(np.int64) for k in range(4))
    if ((op < 0) | (op >= N_OPCODES)).any():
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


def _vm_fields(code: np.ndarray, table: GL, sections: Sequence[GL],
               preloads: Sequence[Tuple[int, GL3]], out_regs: Sequence[int],
               n_regs: int, n: int, roll_k: int) -> dict:
    """Every argument of one launch, tensors in place of their pointers:
    the code on the device, the constant table, each section with its row
    and column strides in words, each preload register with its three
    component vectors and their strides, the register file (zeroed, (R, 3,
    n)), the domain size, the rotation of LOADR (``roll_k`` mod n) and the
    output registers.  The checks are the kernel's: it takes nothing they
    refuse."""
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
    return dict(code=torch.from_numpy(code).to(dev), n_instr=len(code),
                table=table.contiguous(), secs=secs, pre=pre,
                regs=torch.zeros((n_regs, 3, n), dtype=torch.int64, device=dev),
                n_regs=n_regs, n=n, roll_k=roll_k % n,
                out_regs=list(out_regs))


def _launch(f: dict) -> int:
    """One launch of vm_run_kernel on the fields `f`; returns
    cudaGetLastError()."""
    dev = f["regs"].device
    if dev.type != "cuda":
        raise RuntimeError(f"vm_run: unsupported device {dev}")
    a = _VmArgs(code=f["code"].data_ptr(), n_instr=f["n_instr"],
                table=f["table"].data_ptr(), n_secs=len(f["secs"]),
                n_pre=len(f["pre"]), regs=f["regs"].data_ptr(),
                n_regs=f["n_regs"], n=f["n"], roll_k=f["roll_k"])
    for i, (s, rs, cs) in enumerate(f["secs"]):
        a.sec[i], a.sec_rs[i], a.sec_cs[i] = s.data_ptr(), rs, cs
    for i, (r, comps) in enumerate(f["pre"]):
        a.pre_reg[i] = r
        for c, (t, st) in enumerate(comps):
            a.pre[3 * i + c], a.pre_stride[3 * i + c] = t.data_ptr(), st
    with torch.cuda.device(dev):
        return cuda_build.lib().merlin_vm_run(ctypes.addressof(a),
                                              cuda_build.stream_ptr())


def _outputs(f: dict) -> List[GL]:
    return [f["regs"][r] for r in f["out_regs"]]


def vm_run_plain(code: np.ndarray, table: GL, sections: Sequence[GL],
                 preloads: Sequence[Tuple[int, GL3]], out_regs: Sequence[int],
                 n_regs: int, n: int, roll_k: int) -> List[GL]:
    """Plain PyTorch interpreter, same contract as :func:`vm_run`."""
    f = _vm_fields(code, table, sections, preloads, out_regs, n_regs, n, roll_k)
    regs, k = f["regs"], f["roll_k"]
    for r, comps in f["pre"]:
        for c, (t, _st) in enumerate(comps):
            regs[r, c] = gl.canon(t)
    tab = f["table"]

    def reg(r: int) -> GL3:
        return GL3(regs[r, 0], regs[r, 1], regs[r, 2])

    def const(c: int) -> GL3:
        return GL3(tab[c, 0], tab[c, 1], tab[c, 2])

    def load(s: int, poscode: int, rotate: bool) -> GL3:
        m = f["secs"][s][0]
        pos, dim = poscode >> 2, poscode & 3
        cols = [gl.canon(m[:, pos + j]) for j in range(3 if dim == 3 else 1)]
        if rotate:
            cols = [torch.roll(c, -k) for c in cols]
        while len(cols) < 3:
            cols.append(torch.zeros_like(cols[0]))
        return GL3(*cols)

    for op, a, b, dst in np.asarray(code).tolist():
        if op == ADD:
            v = gl3.add(reg(a), reg(b))
        elif op == SUB:
            v = gl3.sub(reg(a), reg(b))
        elif op == MUL:
            v = gl3.mul(reg(a), reg(b))
        elif op == ADDC:
            v = gl3.add(reg(a), const(b))
        elif op == SUBC:
            v = gl3.sub(reg(a), const(b))
        elif op == CSUBC:
            v = gl3.sub(gl3.broadcast_to(const(b), (n,)), reg(a))
        elif op == MULC:
            v = gl3.mul(reg(a), const(b))
        elif op == NEG:
            v = gl3.neg(reg(a))
        elif op in (LOAD, LOADR):
            v = load(a, b, op == LOADR)
        else:  # LOADC
            v = const(a)
        # every operand is read above, before dst is written (dst may be a
        # or b after register recycling)
        regs[dst, 0], regs[dst, 1], regs[dst, 2] = v
    return _outputs(f)


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
