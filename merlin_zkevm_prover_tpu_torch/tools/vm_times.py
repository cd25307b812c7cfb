"""Device times of the VM interpreter kernel (``csrc/vm_gl.cu``).

    python -m merlin_zkevm_prover_tpu_torch.tools.vm_times \\
        [--define NAME=VALUE ...] [--programs smoke4,random,wide,spill]
        [--no-check] [--runs 7] [--out FILE]

Needs one CUDA card and nvcc.  Times one launch of the kernel (CUDA
events, the card kept busy ahead of each launch, median of ``--runs``) on
the arguments ``ops.vm_cuda._vm_fields`` builds for each program, seeded:

``smoke4``  the smoke circuit's step-4 program of the ``n_bits = 17``
            proof, ``2^18`` rows (146 instructions, 6 registers);
``random``  a 6,000-instruction program of every opcode over 32
            registers, ``2^18`` rows, every register an output;
``wide``    ``models/wide.py``'s step-4 program at ``n_bits = 17``,
            ``2^18`` rows (some 6,350 instructions over some 30 registers,
            3,100 loads from 190 columns);
``wide_cols``  the same with its sections stored column-major (what the
            kernel's loads would read if the extended sections were stored
            transposed);
``spill``   a 2,000-instruction program over 400 registers, ``2^16``
            rows, every register an output: more than a block's shared
            memory holds;
``adds``, ``muls``, ``loads``  6,000 base ADDs, extension MULs or base
            LOADs from a 190-column section, ``2^18`` rows.

Each is first held against ``vm_run_plain`` on the card, exactly, unless
``--no-check``.  ``--budget BYTES`` also times each program with that
shared-memory budget a block.  ``--define VM_ROWS_PER_THREAD=2`` builds the kernels from
a copy of ``csrc/`` in which that ``#define`` has the given value.  Prints
one JSON object with the card's name and power limit, the kernel's
registers and, where the package plans its launches, each plan.

It only calls functions the VM has had since it was first ported, so it
also times an older checkout once this file is copied into it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..models.smoke import build_smoke_air
from ..models.wide import build_wide_air
from ..ops import cuda_build, vm_cuda
from ..ops import goldilocks as gl
from ..ops.goldilocks3 import GL3
from ..stark import compile_air, vm
from ..utils.timer import device_time_ms

P = gl.P
# the edge operands and two words in [p, 2^64), which are read modulo p
EDGE = np.array([0, 1, (1 << 32) - 1, 1 << 32, P - (1 << 32), P - 1, P,
                 (1 << 64) - 1], dtype=np.uint64)


def random_program(rng, n_instr: int, n_regs: int, widths,
                   n_consts: int) -> np.ndarray:
    """A seeded (n_instr, 4) program of every opcode: a load into every
    register first, then random instructions whose destinations may alias
    their operands."""
    def load(op, dst):
        s = int(rng.integers(0, len(widths)))
        dim = 3 if widths[s] >= 3 and rng.integers(0, 2) else 1
        pos = int(rng.integers(0, widths[s] - (2 if dim == 3 else 0)))
        return (op, s, (pos << 2) | dim, dst)

    code = [load(vm.LOAD, r) for r in range(n_regs)]
    while len(code) < n_instr:
        op, dst = int(rng.integers(0, 11)), int(rng.integers(0, n_regs))
        a, b = (int(v) for v in rng.integers(0, n_regs, 2))
        c = int(rng.integers(0, n_consts))
        if op in (vm.LOAD, vm.LOADR):
            code.append(load(op, dst))
        elif op == vm.LOADC:
            code.append((op, c, 0, dst))
        elif op in (vm.ADDC, vm.SUBC, vm.CSUBC, vm.MULC):
            code.append((op, a, c, dst))
        else:
            code.append((op, a, 0 if op == vm.NEG else b, dst))
    return np.array(code, dtype=np.int32)


class Data:
    """Seeded field words on a device, edge words planted across the first
    rows of a section."""

    def __init__(self, dev, seed: int):
        self.dev = dev
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seed)

    def rnd(self, *shape) -> torch.Tensor:
        return torch.randint(0, 1 << 62, shape, generator=self.gen,
                             device=self.dev, dtype=torch.int64)

    def section(self, n: int, w: int, pad: int = 3) -> torch.Tensor:
        """An (n, w) column slice of an (n, w + pad) matrix, the edge words
        across its first rows, rotated by row."""
        x = self.rnd(n, w + pad)
        for j in range(min(len(EDGE), n)):
            x[j] = gl.from_u64(np.resize(np.roll(EDGE, j), w + pad), self.dev)
        return x[:, 1:1 + w]


def step4_case(air, data: Data, col_major: bool = False):
    """vm_run's arguments for `air`'s step-4 program (n_queries 32) over
    the extended domain, sections column slices (of column-major matrices
    with `col_major`), and the program."""
    info = compile_air(air, n_queries=32)
    prog = vm.compile_program([(("acc", 0), info.c_exp)], info, "ext",
                              ["cm1_2ns", "cm2_2ns", "cm3_2ns", "const"])
    n = info.n_ext
    secs = {}
    for name in prog.sections:
        w = info.n_constants if name == "const" else \
            info.section_widths[name.replace("_2ns", "_n")]
        secs[name] = data.section(n, w)
        if col_major:
            secs[name] = secs[name].T.contiguous().T
    ch = GL3(data.rnd(8), data.rnd(8), data.rnd(8))
    code, table, sections, preloads = vm._launch_inputs(
        prog, secs, n, ch, data.rnd(max(info.n_publics, 1)), data.rnd(n),
        data.rnd(n), None, None, None)
    return (code, table, sections, preloads, list(prog.out_regs.values()),
            prog.n_regs, n, 1 << info.blowup_bits), prog


def random_case(data: Data, n_instr: int, n_regs: int, n: int, roll_k: int,
                seed: int, widths=(7, 2, 27, 6), out_regs=None):
    """vm_run's arguments for a seeded random program over n rows, one
    preload (register 0)."""
    code = random_program(np.random.default_rng(seed), n_instr, n_regs,
                          widths, 64)
    secs = [data.section(n, w) for w in widths]
    return (code, data.rnd(64, 3), secs,
            [(0, GL3(data.rnd(n), data.rnd(n), data.rnd(n)))],
            list(range(n_regs)) if out_regs is None else out_regs, n_regs, n,
            roll_k)


def synthetic_case(data: Data, kind: str, n: int = 1 << 18,
                   n_instr: int = 6000):
    """One kind of instruction over and over: ``adds`` (base ADD),
    ``muls`` (extension MUL), ``loads`` (base LOAD of seeded columns of a
    190-column section)."""
    rng = np.random.default_rng(7)
    if kind == "loads":
        code = [(vm.LOAD, 0, (int(c) << 2) | 1, k % 4)
                for k, c in enumerate(rng.integers(0, 190, n_instr))]
        w = 190
    else:
        dim = 1 if kind == "adds" else 3
        op = vm.ADD if kind == "adds" else vm.MUL
        code = [(vm.LOAD, 0, dim, 0), (vm.LOAD, 0, (3 << 2) | dim, 1)] + [
            (op, k % 2, 1 - k % 2, k % 2) for k in range(n_instr - 2)]
        w = 7
    return (np.array(code, dtype=np.int32), data.rnd(1, 3),
            [data.section(n, w)], [], [0, 1], 4, n, 1)


def cases(dev, names):
    data = Data(dev, 2026)
    out = {}
    if "smoke4" in names:
        out["smoke4"] = step4_case(build_smoke_air(n_bits=17, seed=42)[0],
                                   data)[0]
    if "random" in names:
        out["random"] = random_case(data, 6000, 32, 1 << 18, 4, 2027)
    if "wide" in names:
        out["wide"] = step4_case(build_wide_air(n_bits=17, device=dev)[0],
                                 data)[0]
    if "wide_cols" in names:
        out["wide_cols"] = step4_case(build_wide_air(n_bits=17, device=dev)[0],
                                      data, col_major=True)[0]
    if "spill" in names:
        out["spill"] = random_case(data, 2000, 400, 1 << 16, 3, 2028)
    for kind in ("adds", "muls", "loads"):
        if kind in names:
            out[kind] = synthetic_case(data, kind)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--define", action="append", default=[])
    ap.add_argument("--programs", default="smoke4,random,wide,spill")
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--budget", type=int, action="append", default=[],
                    help="also time each program with this shared-memory "
                    "budget a block (bytes), where the package takes one")
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("vm_times: needs a CUDA card")
    if args.define:
        cuda_build.CSRC = cuda_build.variant_csrc(args.define)
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, timeout=60).stdout.strip()
    cuda_build.lib()
    res = {"card": card, "defines": args.define,
           "build_s": cuda_build.BUILD_SECONDS,
           "vm_run_kernel": cuda_build.resources(cuda_build.BUILD_LOG).get(
               "vm_run_kernel"), "programs": {}}
    for name, a in cases(dev, args.programs.split(",")).items():
        row = {"instructions": len(a[0]), "registers": a[5], "rows": a[6]}
        f = vm_cuda._vm_fields(*a)
        cuda_build.check(vm_cuda._launch(f), "vm_run launch")
        if not args.no_check and not all(
                torch.equal(g, w) for g, w in
                zip(vm_cuda._outputs(f), vm_cuda.vm_run_plain(*a))):
            raise AssertionError(f"vm_times: {name} differs from the plain "
                                 "interpreter")
        row["ms"] = device_time_ms(lambda: vm_cuda._launch(f), args.runs)
        if "plan" in f:
            row["plan"] = f["plan"]
        del f
        for budget in args.budget:
            f = vm_cuda._vm_fields(*a, budget=budget)
            cuda_build.check(vm_cuda._launch(f), "vm_run launch")
            row[f"budget_{budget}"] = {
                "ms": device_time_ms(lambda: vm_cuda._launch(f), args.runs),
                "plan": f["plan"]}
            del f
        res["programs"][name] = row
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
