"""Groth16 prover over BN254 (reference src/rapidsnark/groth16.c.hpp:49-204).

Flow, identical to the reference:
  1. Build the A/B evaluation vectors from the coefficient table and the
     witness; C = A o B pointwise (R1CS satisfied on the domain).
  2. 3x (iFFT -> eta-coset shift -> FFT) to evaluate A, B, C on the odd
     coset; buffH = A o B - C there.
  3. 5 MSMs: pi_a (A table), pib1 (B1), pi_b (B2 over G2), C-table and H
     commitments folded into pi_c with the r/s blinding.

The FFTs (kernel B2), the MSMs (B3) and the blinding's scalar products (B4)
run on the key's device, and so does the coefficient scatter
(``build_abc``).  The key's point tables are B3's bases: affine words
(``msm.affine_bases``), made affine once where the key is made.
"""

from __future__ import annotations

import math
import secrets
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from ..ops import bn254_cuda
from ..ops import bn254_field as bf
from ..ops.bn254_field import FQ, FR
from . import curve, fft, msm
from .curve import F1, F2, Fq2El, Point
from .setup import Coefs


@dataclass
class Groth16Key:
    """Proving key (zkey) contents; the points on one device."""

    n_vars: int
    n_public: int          # number of public signals EXCLUDING the 1
    domain_bits: int
    coefs: Coefs           # A and B coefficient table
    vk_alpha1: Point       # G1
    vk_beta1: Point
    vk_delta1: Point
    vk_beta2: Point        # G2
    vk_delta2: Point
    # the tables as (rows, 2 W) affine words (msm.affine_bases)
    points_a: torch.Tensor   # (n_vars,) G1
    points_b1: torch.Tensor  # (n_vars,) G1
    points_b2: torch.Tensor  # (n_vars,) G2
    points_c: torch.Tensor   # (n_vars - n_public - 1,) G1
    points_h: torch.Tensor   # (2^domain_bits,) G1

    @property
    def device(self) -> torch.device:
        return self.points_a.device


def _ints_to_limbs(vals, device) -> torch.Tensor:
    return bf.scalars_to_limbs([int(v) % FR.mod for v in vals], device)


def _g1_table_from_affine(pairs, device) -> Point:
    xs = bf.from_int(FQ, [p[0] for p in pairs], device)
    ys = bf.from_int(FQ, [p[1] for p in pairs], device)
    inf = torch.tensor([p[0] == 0 and p[1] == 0 for p in pairs],
                       dtype=torch.bool, device=device)
    zs = bf.select(inf, bf.zeros((len(pairs),), device),
                   bf.mont_one(FQ, (len(pairs),), device))
    return Point(xs, ys, zs)


def _g2_table_from_affine(pairs, device) -> Point:
    def comp(i, j):
        return bf.from_int(FQ, [p[i][j] for p in pairs], device)

    n = len(pairs)
    inf = torch.tensor([all(v == 0 for c in p for v in c) for p in pairs],
                       dtype=torch.bool, device=device)
    zs = Fq2El(bf.select(inf, bf.zeros((n,), device),
                         bf.mont_one(FQ, (n,), device)), bf.zeros((n,), device))
    return Point(Fq2El(comp(0, 0), comp(0, 1)), Fq2El(comp(1, 0), comp(1, 1)),
                 zs)


def key_from_zkey(zk, device=None) -> Groth16Key:
    """snarkjs ZKeyData -> proving key (reference zkey_utils.cpp role)."""
    from ..ops.goldilocks import resolve_device

    device = resolve_device(device)

    def g1(p):
        return _index0(F1, _g1_table_from_affine([p], device))

    def g2(p):
        return _index0(F2, _g2_table_from_affine([p], device))

    def table(F, pairs):
        zero = (0, 0) if F is F1 else ((0, 0), (0, 0))
        return curve.affine_words_from_ints(
            F, [None if tuple(map(_tuple, p)) == zero else p for p in pairs],
            device)

    return Groth16Key(
        n_vars=zk.n_vars, n_public=zk.n_public,
        domain_bits=int(math.log2(zk.domain_size)),
        coefs=Coefs.from_list(zk.coefs, device),
        vk_alpha1=g1(zk.alpha1), vk_beta1=g1(zk.beta1),
        vk_delta1=g1(zk.delta1), vk_beta2=g2(zk.beta2),
        vk_delta2=g2(zk.delta2),
        points_a=table(F1, zk.points_a),
        points_b1=table(F1, zk.points_b1),
        points_b2=table(F2, zk.points_b2),
        points_c=table(F1, zk.points_c) if zk.points_c else None,
        points_h=table(F1, zk.points_h),
    )


def _tuple(c):
    return tuple(c) if isinstance(c, (list, tuple)) else c


def _index0(F, p: Point) -> Point:
    return Point(*[curve._index0(F, leaf) for leaf in p])


def key_to_zkey(key: Groth16Key):
    """Export a proving key as snarkjs ZKeyData (dev-setup interop)."""
    from .binfile import ZKeyData

    def table(F, pts):
        if pts is None:
            return []
        zero = (0, 0) if F is F1 else ((0, 0), (0, 0))
        return [zero if a is None else a for a in curve.affine_ints(F, pts)]

    def one(F, p):
        return table(F, Point(*[curve._unsqueeze1(F, leaf) for leaf in p]))[0]

    return ZKeyData(
        n_vars=key.n_vars, n_public=key.n_public,
        domain_size=1 << key.domain_bits,
        alpha1=one(F1, key.vk_alpha1), beta1=one(F1, key.vk_beta1),
        delta1=one(F1, key.vk_delta1), beta2=one(F2, key.vk_beta2),
        gamma2=one(F2, curve.g2_generator(key.device)),
        delta2=one(F2, key.vk_delta2),
        ic=[], coefs=key.coefs.as_list(),
        points_a=table(F1, key.points_a), points_b1=table(F1, key.points_b1),
        points_b2=table(F2, key.points_b2), points_c=table(F1, key.points_c),
        points_h=table(F1, key.points_h),
    )


def build_abc(key: Groth16Key, witness) -> Tuple[torch.Tensor, torch.Tensor]:
    """A/B evaluation vectors on the constraint domain, Montgomery (n, 4) on
    the key's device: for each matrix and constraint, the sum of
    coef * witness[signal] (the reference's host scatter over every
    coefficient; here the products are kernel B2's, their sums by
    constraint B3's ``msm.sum_by_key``).  `witness`: python ints or Montgomery (n_vars, 4) limbs."""
    n = 1 << key.domain_bits
    co = key.coefs
    if not isinstance(witness, torch.Tensor):
        witness = bf.from_int(FR, list(witness), key.device)
    prods = bn254_cuda.mont_mul(FR, bf.to_mont(FR, co.value), witness[co.s])
    out = []
    for m in (0, 1):
        sel = torch.nonzero(co.m == m).reshape(-1)
        out.append(msm.sum_by_key_unsorted(None, prods[sel], co.c[sel], n))
    return out[0], out[1]


def prove(key: Groth16Key, witness: List[int],
          r: Optional[int] = None, s: Optional[int] = None) -> Dict:
    """Returns {"pi_a", "pi_b", "pi_c", "publics"} (affine coordinates)."""
    assert len(witness) == key.n_vars
    assert witness[0] == 1
    dev = key.device
    if r is None:
        r = secrets.randbelow(FR.mod)
    if s is None:
        s = secrets.randbelow(FR.mod)

    # ---- H values on the eta-coset ----
    w_scalars = _ints_to_limbs(witness, dev)
    a_m, b_m = build_abc(key, bf.to_mont(FR, w_scalars))
    c_m = bn254_cuda.mont_mul(FR, a_m, b_m)
    eta = fft.w_fr(key.domain_bits + 1)

    def coset_evals(vals):
        return fft.fft(fft.coset_scale(fft.ifft(vals), eta))

    a_odd = coset_evals(a_m)
    b_odd = coset_evals(b_m)
    c_odd = coset_evals(c_m)
    del a_m, b_m, c_m
    h_scalars = bf.from_mont(FR, bn254_cuda.mul_sub(a_odd, b_odd, c_odd))
    del a_odd, b_odd, c_odd

    # ---- MSMs ----
    pi_a_msm = msm.msm(F1, key.points_a, w_scalars)
    pib1_msm = msm.msm(F1, key.points_b1, w_scalars)
    pi_b_msm = msm.msm(F2, key.points_b2, w_scalars)
    if key.points_c is not None and key.n_vars > key.n_public + 1:
        pi_c_msm = msm.msm(F1, key.points_c, w_scalars[key.n_public + 1:])
    else:
        pi_c_msm = curve.infinity(F1, (), dev)
    h_msm = msm.msm(F1, key.points_h, h_scalars)

    # ---- blinding ----
    pi_a = curve.add(F1, pi_a_msm, key.vk_alpha1)
    pi_a = curve.add(F1, pi_a, curve.scalar_mul(F1, key.vk_delta1, r))
    pib1 = curve.add(F1, pib1_msm, key.vk_beta1)
    pib1 = curve.add(F1, pib1, curve.scalar_mul(F1, key.vk_delta1, s))
    pi_b = curve.add(F2, pi_b_msm, key.vk_beta2)
    pi_b = curve.add(F2, pi_b, curve.scalar_mul(F2, key.vk_delta2, s))

    pi_c = curve.add(F1, pi_c_msm, h_msm)
    pi_c = curve.add(F1, pi_c, curve.scalar_mul(F1, pi_a, s))
    pi_c = curve.add(F1, pi_c, curve.scalar_mul(F1, pib1, r))
    rs = (r * s) % FR.mod
    pi_c = curve.add(F1, pi_c, curve.scalar_mul(F1, key.vk_delta1,
                                                FR.mod - rs))

    def aff1(p):
        return curve.affine_ints(F1, Point(*[leaf[None] for leaf in p]))[0]

    (ax, ay), (cx, cy) = aff1(pi_a), aff1(pi_c)
    (bx, by), = curve.affine_ints(F2, Point(*[curve._unsqueeze1(F2, leaf)
                                              for leaf in pi_b]))
    return {
        "pi_a": [ax, ay, 1],
        "pi_b": [[bx[0], bx[1]], [by[0], by[1]], [1, 0]],
        "pi_c": [cx, cy, 1],
        "publics": [int(w) for w in witness[1: key.n_public + 1]],
        "protocol": "groth16",
        "curve": "bn128",
    }
