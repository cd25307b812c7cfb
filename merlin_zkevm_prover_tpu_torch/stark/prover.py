"""The 5-step STARK prover (reference Starks::genProof).

Pipeline per proof, with the exact reference transcript order:

  step1: LDE(cm1) -> tree0 -> root0
  step2: challenges u, defVal -> f/t expressions -> plookup h1/h2 ->
         LDE(cm2) -> tree1 -> root1
  step3: challenges gamma, beta -> num/den im pols -> grand products z ->
         LDE(cm3) -> tree2 -> root2
  step4: challenge alpha -> quotient on ext domain -> INTT/split/NTT ->
         cm4 -> tree3 -> root3
  step5: challenge xi -> evmap -> evals -> challenges v1, v2 ->
         xDivXSubXi -> FRI polynomial
  FRI:   fold/commit per step, queries

All bulk math is in the device stage functions (device_core.py); only
roots, challenges and query rows cross the host boundary (bytes per
interaction, the reference's own host/device split).

Each step takes the small-circuit path (expression programs on the tree
evaluator, step 5 in the per-polynomial form) or the large-circuit path
(steps 2-4 on the VM, step 5 as weighted column sums) by the size of its
program, against the thresholds of ROUTE_DEFAULTS.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops import goldilocks3 as gl3
from ..ops.goldilocks import GL, P, SHIFT
from ..ops.goldilocks3 import GL3
from ..utils.timer import TimerLog
from . import device_core as core
from . import plookup as plookup_mod
from . import vm as vm_mod
from .compiler import StarkInfo
from .fri import fri_prove
from .merkle_tree import MerkleTreeGL
from .proof import StarkProof, TreeOpening
from .transcript import Transcript

HASH_SIZE = 4
STEP_MAX_NODES = 250  # expression nodes per evaluation chunk

# A step program above MERLIN_VM_MIN_NODES expression nodes runs on the VM;
# step 5 takes the matrix forms above MERLIN_STEP5_MATRIX_MIN evaluation-map
# entries.  Either name set in the environment overrides its default.  On
# the card the large-circuit path took less time at every program size
# measured (smoke and wide circuits, tools/route_times.py, PERF.md), so it
# is taken always.  On the CPU the defaults are the reference's
# (prover.py:121-188), so a CPU proof takes the route the reference takes.
ROUTE_DEFAULTS = {
    "cuda": {"MERLIN_VM_MIN_NODES": 0, "MERLIN_STEP5_MATRIX_MIN": 0},
    "cpu": {"MERLIN_VM_MIN_NODES": 3000, "MERLIN_STEP5_MATRIX_MIN": 128},
}


def route_thresholds(device: torch.device) -> Dict[str, int]:
    """The two thresholds a StarkProver on `device` reads at construction."""
    defaults = ROUTE_DEFAULTS["cuda" if device.type == "cuda" else "cpu"]
    return {k: int(os.environ.get(k, v)) for k, v in defaults.items()}


def _challenges_gl3(ch: List[Optional[List[int]]], device) -> GL3:
    vals = np.zeros((8, 3), dtype=np.uint64)
    for i, c in enumerate(ch):
        if c is not None:
            vals[i] = c
    return gl3.from_u64(vals, device)


def program_nodes(prog) -> int:
    """Distinct expression nodes of a step program (dest, expr) list."""
    seen: set = set()
    return sum(core._expr_new_nodes(e, seen) for _d, e in prog)


class StarkProver:
    """Preprocessed proving context for one circuit: const pols, const tree
    and domain tables, all on `device` (``None`` means the GPU; there is no
    fall-back to the CPU).  The commitment scheme is the Poseidon-GL binary
    tree with the GL sponge transcript (reference Starks).
    """

    def __init__(self, info: StarkInfo, const_values: np.ndarray, device=None):
        self.info = info
        self.device = gl.resolve_device(device)
        dev = self.device
        n, n_ext = info.n, info.n_ext
        assert const_values.shape == (n, info.n_constants)
        self.const_n = gl.from_u64(const_values.astype(np.uint64), dev)
        self.const_2ns = core.extend_section(info, self.const_n)
        self.const_tree = MerkleTreeGL(self.const_2ns)
        self.const_tree.merkelize()

        self.x_n = gl.powers(gl.w(info.n_bits), n, device=dev)
        self.x_2ns = gl.powers(gl.w(info.n_bits_ext), n_ext, start=SHIFT,
                               device=dev)
        blow = 1 << info.blowup_bits
        sn = pow(SHIFT, n, P)
        zi_period = np.array(
            [
                pow((sn * pow(gl.w(info.blowup_bits), i, P) - 1) % P, P - 2, P)
                for i in range(blow)
            ],
            dtype=np.uint64,
        )
        self.zi = gl.from_u64(np.tile(zi_period, n), dev)

        # A program above the VM threshold runs on the VM (stark/vm.py: one
        # interpreter launch per program); one at or below it, on the tree
        # evaluator in node-count-bounded chunks (a fresh memo per chunk
        # bounds the whole-domain intermediates alive at once).
        max_nodes = STEP_MAX_NODES
        limits = route_thresholds(dev)
        vm_min = limits["MERLIN_VM_MIN_NODES"]
        step5_matrix_min = limits["MERLIN_STEP5_MATRIX_MIN"]

        self._vm2 = self._vm3 = self._vm4 = None
        if program_nodes(info.step2prev) > vm_min:
            self._vm2 = vm_mod.compile_program(info.step2prev, info, "n",
                                               ["cm1_n", "const"])
        else:
            self._step2_spans = core.plan_program_chunks(info.step2prev,
                                                         max_nodes)
        if program_nodes(info.step3prev) > vm_min:
            self._vm3 = vm_mod.compile_program_ordered(
                info.step3prev, info, "n", ["cm1_n", "cm2_n", "const"])
        else:
            self._step3_spans = core.plan_program_chunks(info.step3prev,
                                                         max_nodes)
            self._step3_needs = core.chunk_pending_inputs(
                info.step3prev, self._step3_spans)
        if program_nodes(info.step42ns) > vm_min:
            self._vm4 = vm_mod.compile_program(
                [(("acc", 0), info.c_exp)], info, "ext",
                ["cm1_2ns", "cm2_2ns", "cm3_2ns", "const"])
        else:
            self._step4_spans = core.step4_span_chunks(info, max_nodes)
        self._step5_matrix = len(info.ev_map) > step5_matrix_min

    # ------------------------------------------------------------------
    def prove(self, cm1_trace: np.ndarray, publics: Optional[np.ndarray] = None,
              timer: Optional[TimerLog] = None) -> StarkProof:
        info = self.info
        dev = self.device
        n = info.n
        tlog = timer or TimerLog(f"stark:{info.name}", quiet=True)
        if publics is None:
            publics = np.array(
                [cm1_trace[row, cid] for (_, cid, row) in info.publics],
                dtype=np.uint64,
            )
        publics = np.asarray(publics, dtype=np.uint64)
        assert publics.shape == (info.n_publics,)
        publics_dev = gl.from_u64(publics, dev)

        transcript = Transcript()
        transcript.put([int(x) for x in publics])
        challenges: List[Optional[List[int]]] = [None] * 8

        sections: Dict[str, GL] = {}
        trees: Dict[str, MerkleTreeGL] = {}

        def commit(name: str, section_n: GL):
            lde = core.extend_section(info, section_n)
            sections[f"{name}_2ns"] = lde
            tree = MerkleTreeGL(lde)
            tree.merkelize()
            trees[name.replace("_n", "")] = tree
            return tree

        # ---- step 1 ----
        with tlog.span("STARK_STEP_1"):
            assert cm1_trace.shape == (n, info.n_cm[0])
            sections["cm1_n"] = gl.from_u64(cm1_trace.astype(np.uint64), dev)
            tree = commit("cm1", sections["cm1_n"])
            transcript.put(tree.root())

        # ---- step 2 ----
        with tlog.span("STARK_STEP_2"):
            challenges[0] = transcript.get_field()
            challenges[1] = transcript.get_field()
            ch_dev = _challenges_gl3(challenges, dev)
            exp_vals: Dict[int, object] = {}
            if self._vm2 is not None:
                out = core.step2_vm(info, self._vm2,
                                    {"cm1_n": sections["cm1_n"]}, self.const_n,
                                    ch_dev, publics_dev, self.x_n)
                for eid, v in out.items():
                    # dim-1 expressions ride the VM as GL3 with zero high
                    # components; drop to GL so the h1/h2 sort keys stay
                    # single-word
                    exp_vals[eid] = v.c0 if info.exp_dims[eid] == 1 else v
                del out
            else:
                for (e0, e1) in self._step2_spans:
                    exp_vals.update(core.step2_exprs_chunk(
                        info, e0, e1, {"cm1_n": sections["cm1_n"]},
                        self.const_n, ch_dev, publics_dev, self.x_n))
            h_cols: Dict[int, object] = {}
            oks = []
            for pu in info.pu_ctx:
                h1, h2, ok = plookup_mod.calculate_h1h2(
                    exp_vals[pu.f_exp_id], exp_vals[pu.t_exp_id])
                h_cols[pu.h1_id] = h1
                h_cols[pu.h2_id] = h2
                oks.append(ok)
            if oks and not bool(torch.stack(oks).all()):
                raise ValueError("plookup: f value not included in t")
            cm2_n = core.step2_assemble(info, h_cols, dev)
            del exp_vals, h_cols
            sections["cm2_n"] = cm2_n
            tree = commit("cm2", cm2_n)
            transcript.put(tree.root())

        # ---- step 3 ----
        with tlog.span("STARK_STEP_3"):
            challenges[2] = transcript.get_field()
            challenges[3] = transcript.get_field()
            ch_dev = _challenges_gl3(challenges, dev)
            sec3_in = {"cm1_n": sections["cm1_n"],
                       "cm2_n": sections["cm2_n"]}
            pending: Dict[int, object] = {}
            if self._vm3 is not None:
                out = core.step3_vm(info, self._vm3, sec3_in, self.const_n,
                                    ch_dev, publics_dev, self.x_n)
                for pid, v in out.items():
                    pending[pid] = v.c0 if info.cm_pols[pid].dim == 1 else v
                del out
            else:
                for (e0, e1), need in zip(self._step3_spans,
                                          self._step3_needs):
                    pending.update(core.step3_exprs_chunk(
                        info, e0, e1, sec3_in, self.const_n, ch_dev,
                        publics_dev, self.x_n, {i: pending[i] for i in need}))

            def _as3(v):
                return v if isinstance(v, GL3) else gl3.from_base(v)

            cm3_cols = dict(pending)
            for ctxs in (info.pu_ctx, info.pe_ctx, info.ci_ctx):
                for c in ctxs:
                    num = _as3(pending[c.num_id])
                    den = _as3(pending[c.den_id])
                    cm3_cols[c.num_id] = num
                    cm3_cols[c.den_id] = den
                    cm3_cols[c.z_id] = plookup_mod.calculate_z(num, den)
            cm3_n = core.step3_assemble(info, cm3_cols, dev)
            del pending, cm3_cols, sec3_in
            sections["cm3_n"] = cm3_n
            tree = commit("cm3", cm3_n)
            del cm3_n
            transcript.put(tree.root())

        # ---- step 4 ----
        # n-domain sections are dead from here (steps 4/5 read only the
        # extended domain); drop them so their memory is reusable
        for k in ("cm1_n", "cm2_n", "cm3_n"):
            sections.pop(k, None)
        with tlog.span("STARK_STEP_4"):
            challenges[4] = transcript.get_field()
            ch_dev = _challenges_gl3(challenges, dev)
            ext_sections = {
                k: sections[k]
                for k in ("cm1_2ns", "cm2_2ns", "cm3_2ns")
            }
            if self._vm4 is not None:
                cm4 = core.step4_vm(info, self._vm4, ext_sections,
                                    self.const_2ns, ch_dev, publics_dev,
                                    self.x_2ns, self.zi)
            else:
                acc = gl3.zeros((info.n_ext,), dev)
                for (k0, k1) in self._step4_spans:
                    acc = core.step4_chunk(info, k0, k1, ext_sections,
                                           self.const_2ns, ch_dev, publics_dev,
                                           self.x_2ns, self.zi, acc)
                cm4 = core.step4_finalize(info, acc, self.zi)
                del acc
            sections["cm4_2ns"] = cm4
            tree = MerkleTreeGL(cm4)
            tree.merkelize()
            trees["cm4"] = tree
            transcript.put(tree.root())

        # ---- step 5 ----
        with tlog.span("STARK_STEP_5"):
            challenges[7] = transcript.get_field()
            xi_dev = gl3.const(*challenges[7], device=dev)
            ext_sections["cm4_2ns"] = sections["cm4_2ns"]
            step5_evals, step5_fri = (
                (core.step5_evals_matrix, core.step5_fri_matrix)
                if self._step5_matrix else
                (core.step5_evals, core.step5_fri_pol))
            evals = step5_evals(info, ext_sections, self.const_2ns, xi_dev)
            evals_np = gl3.to_u64(evals)
            for e in evals_np:
                transcript.put([int(v) for v in e])
            challenges[5] = transcript.get_field()
            challenges[6] = transcript.get_field()
            ch_dev = _challenges_gl3(challenges, dev)
            f_val = step5_fri(
                info, ext_sections, self.const_2ns, ch_dev, publics_dev,
                self.x_2ns, self.zi, evals, xi_dev,
            )

        # ---- FRI ----
        with tlog.span("STARK_FRI"):
            fri_trees, final_pol, _ = fri_prove(
                transcript, f_val, info.fri_step_bits)
            ys = transcript.get_permutations(
                info.n_queries, info.fri_step_bits[0]
            )
            # one fetch per tree for the rows of all queries
            opened = {tn: trees[tn].get_group_proofs(ys)
                      for tn in ("cm1", "cm2", "cm3", "cm4")}
            opened["const"] = self.const_tree.get_group_proofs(ys)
            queries_step0 = [
                {tn: TreeOpening([int(v) for v in rows_sibs[qi][0]],
                                 rows_sibs[qi][1])
                 for tn, rows_sibs in opened.items()}
                for qi in range(len(ys))
            ]

            queries_fri = []
            cur_ys = list(ys)
            for si in range(1, len(info.fri_step_bits)):
                bits = info.fri_step_bits[si]
                cur_ys = [y % (1 << bits) for y in cur_ys]
                queries_fri.append([
                    TreeOpening([int(v) for v in row], sib)
                    for row, sib in fri_trees[si].get_group_proofs(cur_ys)
                ])

        return StarkProof(
            name=info.name,
            roots=[trees[t].root() for t in ("cm1", "cm2", "cm3", "cm4")],
            evals=[[int(v) for v in e] for e in evals_np],
            fri_roots=[t.root() for t in fri_trees[1:]],
            final_pol=[[int(v) for v in e] for e in final_pol],
            queries_step0=queries_step0,
            queries_fri=queries_fri,
            publics=[int(x) for x in publics],
        )
