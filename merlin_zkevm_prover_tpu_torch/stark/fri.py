"""FRI prover — vectorized fold, per-step Merkle commit, query extraction.

Mirrors the reference `FRIProve::prove`: per step, the polynomial is viewed
as nX coset lines of length pol2N, each line is interpolated (INTT),
coset-descaled, and Horner-evaluated at the step challenge; surviving steps
are regrouped and Poseidon-committed; the final polynomial is absorbed raw;
query indices come from the transcript's bit-packing.

The per-group INTT is one batched multi-column INTT over the
(nX, pol2N*3) view, and the Horner loop is nX whole-vector steps — no
per-group scalar loops.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops import goldilocks3 as gl3
from ..ops import ntt as nttmod
from ..ops.goldilocks import GL, P, SHIFT
from ..ops.goldilocks3 import GL3
from .transcript import Transcript
from .merkle_tree import MerkleTreeGL


def _gl3_to_mat(v: GL3) -> GL:
    """(n,) GL3 -> (n, 3) matrix (component columns)."""
    return torch.stack([v.c0, v.c1, v.c2], dim=1)


def _mat_to_gl3(m: GL) -> GL3:
    return GL3(m[..., 0], m[..., 1], m[..., 2])


def fold_step(pol: GL3, pol_bits: int, next_bits: int, special_x: GL3,
              shift_inv_cur: int) -> GL3:
    """Fold a (2^pol_bits,) GL3 FRI polynomial down to 2^next_bits values."""
    n = 1 << pol_bits
    pol2n = 1 << next_bits
    nx = n // pol2n
    if nx == 1:
        return pol
    dev = pol.c0.device
    # lines: ppar[i, g] = pol[i * pol2n + g]
    mat = _gl3_to_mat(pol).reshape(nx, pol2n, 3)
    coeffs = nttmod.intt(mat)            # INTT along axis 0, per line & comp

    # descale: coeff row i of line g scaled by (shift_inv_cur * w^-g)^i
    wi = gl.w_inv(pol_bits)
    base = gl.from_u64(gl.powers_np(wi, pol2n, start=shift_inv_cur), dev)
    # power table S[i, g] = base[g]^i, built row by row (nx is small)
    rows = [torch.ones_like(base)]
    for _ in range(nx - 1):
        rows.append(gl.mul(rows[-1], base))
    s_tab = gl.stack(rows, axis=0)
    scaled = gl.mul(coeffs, s_tab[..., None])

    # Horner at special_x over the nx coefficient rows (high to low)
    c = _mat_to_gl3(scaled)              # (nx, pol2n) GL3
    acc = c[nx - 1]
    for i in range(nx - 2, -1, -1):
        acc = gl3.add(gl3.mul(acc, special_x), c[i])
    return acc                           # (pol2n,) GL3


def group_source(pol: GL3, next_bits: int) -> GL:
    """Regroup a (2^b,) GL3 pol into a (2^next_bits, groupSize*3) matrix
    (reference FRIProve::getTransposed layout: group g row =
    [pol[j*nGroups+g] for j], 3 felts per element)."""
    n = pol.shape[0]
    ngroups = 1 << next_bits
    gsz = n // ngroups
    mat = _gl3_to_mat(pol).reshape(gsz, ngroups, 3)
    return mat.permute(1, 0, 2).reshape(ngroups, gsz * 3).contiguous()


def fri_prove(
    transcript: Transcript,
    fri_pol: GL3,
    step_bits: List[int],
    shift_inv: int = None,
) -> Tuple[List[MerkleTreeGL], np.ndarray, List[int]]:
    """Run the FRI fold/commit phase.

    Returns (fri_trees [indexed 1..last], final_pol numpy (M,3), special_xs
    as a list of drawn challenges for debugging).  Queries are drawn by the
    caller after this returns (reference draws them inside FRIProve::prove
    right after the last absorb; order is preserved by calling
    transcript.get_permutations next).
    """
    shift_inv_cur = pow(SHIFT, P - 2, P) if shift_inv is None else shift_inv
    pol = fri_pol
    dev = pol.c0.device
    pol_bits = step_bits[0]
    trees: List[MerkleTreeGL] = [None] * len(step_bits)
    special_xs = []

    for si in range(len(step_bits)):
        special_x_ints = transcript.get_field()
        special_xs.append(special_x_ints)
        special_x = gl3.const(*special_x_ints, device=dev)

        next_bits_fold = step_bits[si]
        pol = fold_step(pol, pol_bits, next_bits_fold, special_x, shift_inv_cur)
        reduction = pol_bits - next_bits_fold
        pol_bits = next_bits_fold

        if si < len(step_bits) - 1:
            src = group_source(pol, step_bits[si + 1])
            tree = MerkleTreeGL(src)
            tree.merkelize()
            trees[si + 1] = tree
            transcript.put(tree.root())
        else:
            final_np = gl3.to_u64(pol)
            for k in range(final_np.shape[0]):
                transcript.put([int(v) for v in final_np[k]])

        for _ in range(reduction):
            shift_inv_cur = (shift_inv_cur * shift_inv_cur) % P

    return trees, gl3.to_u64(pol), special_xs
