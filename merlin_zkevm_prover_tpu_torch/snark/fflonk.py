"""Native fflonk prover/verifier over BN254 (reference
src/rapidsnark/fflonk_prover.c.hpp:1-1714, selected by zkey protocol ID 10
at src/prover/prover.cpp:59,887; the reference CI's acceptance test
verifies a fflonk final proof with snarkjs ffv).

fflonk commits three "combined" polynomials instead of eleven:

  C0(X) = qL(X^8) + X qR(X^8) + X^2 qM(X^8) + X^3 qO(X^8) + X^4 qC(X^8)
        + X^5 S1(X^8) + X^6 S2(X^8) + X^7 S3(X^8)          (setup, zkey)
  C1(X) = a(X^4) + X b(X^4) + X^2 c(X^4) + X^3 T0(X^4)     (round 1)
  C2(X) = z(X^3) + X T1(X^3) + X^2 T2(X^3)                 (round 2)

and opens them on coset root sets S0 (8th roots of xi), S1 (4th roots),
S2 (cube roots of xi and of xi*w) with a single KZG pair (W1, W2) —
rounds 3-5 (fflonk_prover.c.hpp:1153-1560).  The Fiat-Shamir transcript
is Keccak-256 over big-endian scalars and affine G1 coordinates
(keccak_256_transcript.c.hpp:33-78).

The same key, proof and transcript as the JAX package's ``snark/fflonk.py``
(python ints throughout), with the polynomials on the device: (m, 4)
Montgomery tensors (``ops/bn254_field.py``).  FFTs are kernel B2
(``snark/fft.py``), evaluations B2's power table times the coefficients
in one fused B2 launch, commitments B3's MSM over the SRS table (made by
B4, made affine once by B3 and kept so), divisions by ``X^k - beta``, the grand
product's prefix products and sums of polynomials kernel F1 (``scan``),
inverses F2, the quotient numerators F3 (``ops/bn254_fflonk_cuda.py``).
The transcript, the root sets, the interpolations on at most 18 points
and the verifier stay host python ints, as in the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import bn254_cuda
from ..ops import bn254_fflonk_cuda as ffk
from ..ops import bn254_field as bf
from ..ops.goldilocks import resolve_device
from ..utils.keccak import keccak256
from . import curve, fft, msm
from .pairing import (
    F12_ONE,
    G1_GEN,
    G2_GEN,
    Q,
    R as FR,
    g1_add,
    g1_mul,
    g1_neg,
    g2_mul,
    multi_pairing,
)

CTX = bf.FR
TWO_ADICITY = 28          # r - 1 = 2^28 * odd
SELECTORS = ("qL", "qR", "qM", "qO", "qC")
EVAL_KEYS = ("ql", "qr", "qm", "qo", "qc", "s1", "s2", "s3", "a", "b", "c",
             "z", "zw", "t1w", "t2w")

# ---------------------------------------------------------------------------
# Fr helpers (host)
# ---------------------------------------------------------------------------


def _inv(x: int) -> int:
    return pow(x % FR, FR - 2, FR)


def check_domain(n: int) -> None:
    """The prover works on the 4n domain: Fr has 2^28-th roots of unity
    and no larger power of two."""
    if 4 * n > 1 << TWO_ADICITY:
        raise ValueError(
            f"fflonk needs a 4n = 2^{(4 * n).bit_length() - 1}-point domain "
            f"(n = {n} PLONK rows), but the two-adicity of BN254's Fr is "
            f"{TWO_ADICITY}: no root of unity of that order exists")


def _find_w(n: int) -> int:
    """Primitive n-th root of unity in Fr (n | 2^28)."""
    logn = n.bit_length() - 1
    assert 1 << logn == n
    if logn > TWO_ADICITY:
        raise ValueError(f"no {n}-th root of unity in Fr: its two-adicity "
                         f"is {TWO_ADICITY}")
    g = pow(5, (FR - 1) >> TWO_ADICITY, FR)
    return pow(g, 1 << (TWO_ADICITY - logn), FR)


def poly_zerofier(points: List[int]) -> List[int]:
    out = [1]
    for p in points:
        nxt = [0] * (len(out) + 1)
        for i, c in enumerate(out):
            nxt[i] = (nxt[i] - p * c) % FR
            nxt[i + 1] = (nxt[i + 1] + c) % FR
        out = nxt
    return out


def lagrange_interp(xs: List[int], ys: List[int]) -> List[int]:
    """Exact Lagrange interpolation (reference
    Polynomial::lagrangePolynomialInterpolation — the R0/R1/R2 root sets
    are not FFT-friendly)."""
    n = len(xs)
    out = [0] * n
    for i in range(n):
        num = [1]
        denom = 1
        for j in range(n):
            if j == i:
                continue
            nxt = [0] * (len(num) + 1)
            for k, c in enumerate(num):
                nxt[k] = (nxt[k] - xs[j] * c) % FR
                nxt[k + 1] = (nxt[k + 1] + c) % FR
            num = nxt
            denom = denom * (xs[i] - xs[j]) % FR
        scale = ys[i] * _inv(denom) % FR
        for k in range(len(num)):
            out[k] = (out[k] + num[k] * scale) % FR
    return out


# ---------------------------------------------------------------------------
# Polynomials on the device: (m, 4) Montgomery coefficient tensors
# ---------------------------------------------------------------------------


def fr_tensor(vals, device) -> torch.Tensor:
    """Python ints, or (m, 4) uint64 plain canonical limbs -> (m, 4)
    Montgomery on `device`."""
    if isinstance(vals, np.ndarray):
        return bf.to_mont(CTX, bf.from_u64(vals, device))
    return bf.from_int(CTX, [int(v) % FR for v in vals], device).reshape(
        -1, bf.N_LIMBS)


def fr_ints(t: torch.Tensor) -> List[int]:
    return [int(v) for v in bf.to_int(CTX, t).reshape(-1)]


def _zeros(m: int, device) -> torch.Tensor:
    return torch.zeros((m, bf.N_LIMBS), dtype=torch.int64, device=device)


def _const(v: int, device) -> torch.Tensor:
    return bf.const(CTX, v, device)


def _trim(p: torch.Tensor) -> torch.Tensor:
    """Without its trailing zero coefficients."""
    nz = torch.nonzero((p != 0).any(dim=1)).reshape(-1)
    return p[:int(nz[-1]) + 1] if nz.numel() else p[:0]


def _add_small(p: torch.Tensor, small: Sequence[int]) -> torch.Tensor:
    """p + small (a few host coefficients), the length the longer's."""
    m = max(p.shape[0], len(small))
    if m > p.shape[0]:
        p = torch.cat([p, _zeros(m - p.shape[0], p.device)])
    else:
        p = p.clone()
    k = len(small)
    head = fr_ints(p[:k])
    p[:k] = fr_tensor([(h + s) % FR for h, s in zip(head, small)], p.device)
    return p


def poly_from_evals(evals: torch.Tensor) -> torch.Tensor:
    return fft.ifft(evals)


def poly_extend_evals(coefs: torch.Tensor, n_out: int) -> torch.Tensor:
    m = coefs.shape[0]
    if m > n_out:
        raise ValueError(f"poly_extend_evals: {m} coefficients > {n_out}")
    if m < n_out:
        coefs = torch.cat([coefs, _zeros(n_out - m, coefs.device)])
    return fft.fft(coefs)


def poly_eval(coefs, x: int) -> int:
    """sum_i c_i x^i: host Horner for a list of ints; for a (m, 4)
    Montgomery tensor, B2's fused evaluation (no power table written)."""
    if not isinstance(coefs, torch.Tensor):
        acc = 0
        for c in reversed(coefs):
            acc = (acc * x + c) % FR
        return acc
    if coefs.shape[0] == 0:
        return 0
    return fr_ints(bn254_cuda.poly_eval(coefs, x)[None])[0]


def poly_mul_scalar(coefs: torch.Tensor, k: int) -> torch.Tensor:
    return bn254_cuda.mont_mul(CTX, coefs, _const(k, coefs.device))


def poly_sum(polys: Sequence[torch.Tensor],
             scalars: Optional[Sequence[int]] = None) -> torch.Tensor:
    """sum_i scalars[i] polys[i] (scalars 1 when None), the length the
    longest's: the running sum and the next term stacked as two blocks of
    that length, one forward additive F1 scan over chains of that length
    (the second block then holds their sum)."""
    m = max(p.shape[0] for p in polys)
    buf = _zeros(2 * m, polys[0].device)
    for i, p in enumerate(polys):
        k = 1 if scalars is None else scalars[i] % FR
        at = m if i else 0
        if i > 1:
            buf[m:] = 0
        buf[at:at + p.shape[0]] = p if k == 1 else poly_mul_scalar(p, k)
        if i:
            ffk.scan(buf, m, "add", out=buf)
            if i < len(polys) - 1:
                buf[:m] = buf[m:]
    return buf[m:] if len(polys) > 1 else buf[:m]


def poly_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return poly_sum([a, b])


def poly_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return poly_sum([a, b], [1, FR - 1])


def _row_powers(base: int, start: int, rows: int, n: int, m: int, dev):
    """start * base^(i div n) for i < m: B2's power table, repeated n times
    a row (the table itself for n = 1)."""
    pw = bn254_cuda.powers(base, rows, start=start, device=dev)
    if n == 1:
        return pw[:m]
    return pw[torch.arange(m, device=dev) // n]


def poly_div_zerofier(coefs: torch.Tensor, n: int, beta: int) -> torch.Tensor:
    """Divide by (X^n - beta) (reference Polynomial::divByZerofier); raises
    if the remainder is nonzero.  The JAX loop q_{i-n} = p_i + beta q_i
    (high to low) in closed form: on chain c (the coefficients c + u n),
    q_{c + t n} = beta^-(t+1) sum_{u > t} beta^u p_{c + u n}, i.e. p times
    beta^(i div n), a backward additive F1 scan over the n chains, times
    beta^-(i div n + 1); the scan at a chain's first coefficient is the
    remainder p_c + beta q_c."""
    beta %= FR
    m = coefs.shape[0]
    dev = coefs.device
    if m <= n:
        if bool((coefs != 0).any()):
            raise ValueError("poly_div_zerofier: non-zero remainder")
        return coefs[:0]
    rows = -(-m // n)
    if beta != 1:
        s = bn254_cuda.mont_mul(CTX, coefs, _row_powers(beta, 1, rows, n, m, dev))
    else:
        s = coefs.clone()
    ffk.scan(s, n, "add", backward=True, out=s)
    if bool((s[:n] != 0).any()):
        raise ValueError("poly_div_zerofier: non-zero remainder")
    q = s[n:]
    if beta != 1:
        binv = _inv(beta)
        bn254_cuda.mont_mul(CTX, q, _row_powers(binv, binv, rows, n, m - n, dev),
                            out=q)
    return _trim(q)


# ---------------------------------------------------------------------------
# Keccak-256 transcript (reference keccak_256_transcript.c.hpp)
# ---------------------------------------------------------------------------


class KeccakTranscript:
    def __init__(self):
        self.data = b""

    def reset(self):
        self.data = b""

    def add_scalar(self, v: int):
        self.data += int(v % FR).to_bytes(32, "big")

    def add_point(self, p):
        if p is None:
            self.data += b"\x00" * 64
        else:
            self.data += int(p[0]).to_bytes(32, "big")
            self.data += int(p[1]).to_bytes(32, "big")

    def get_challenge(self) -> int:
        return int.from_bytes(keccak256(self.data), "big") % FR


# ---------------------------------------------------------------------------
# PLONK constraint system + setup
# ---------------------------------------------------------------------------

K1 = ffk.K1
K2 = ffk.K2


def _limbs(vals) -> np.ndarray:
    if isinstance(vals, np.ndarray) and vals.dtype == np.uint64:
        return vals
    return bf.ints_to_limbs([int(v) % FR for v in vals])


@dataclass
class PlonkCS:
    """3-wire PLONK: qL a + qR b + qM ab + qO c + qC + PI = 0 per row,
    with copy constraints via the sigma permutation.  Selectors are (n, 4)
    uint64 plain limbs of canonical Fr values (python ints are converted),
    sigma an int64 array over the 3n wire slots."""
    n: int
    qL: np.ndarray
    qR: np.ndarray
    qM: np.ndarray
    qO: np.ndarray
    qC: np.ndarray
    sigma: np.ndarray
    n_public: int = 0

    def __post_init__(self):
        for name in SELECTORS:
            setattr(self, name, _limbs(getattr(self, name)))
        self.sigma = np.asarray(self.sigma, dtype=np.int64)


@dataclass
class FflonkKey:
    cs: PlonkCS
    srs_g1: torch.Tensor            # (9n + 32, 8) tau^i G1, affine words
    x2: tuple                       # tau * G2, affine python ints
    C0: Optional[Tuple[int, int]]
    c0_coefs: torch.Tensor          # Montgomery (m, 4)
    sel_coefs: Dict[str, torch.Tensor]
    sigma_coefs: List[torch.Tensor]
    w: int                          # n-th root of unity

    @property
    def device(self) -> torch.device:
        return self.srs_g1.device


def _affine(p: curve.Point):
    """One projective G1 point -> (x, y) python ints, None for infinity."""
    return curve.affine_ints(curve.F1, curve.Point(*[leaf[None] for leaf in p]))[0]


def _commit(srs: torch.Tensor, coefs: torch.Tensor):
    """sum_i c_i srs_i (B3), None when it is the point at infinity (the
    JAX function skips zero coefficients: B3 skips zero digits)."""
    m = coefs.shape[0]
    if m == 0:
        return None
    if m > srs.shape[0]:
        raise ValueError(f"commit: {m} coefficients > {srs.shape[0]} SRS points")
    return _affine(msm.msm(curve.F1, srs[:m], bf.from_mont(CTX, coefs)))


def _combine(polys: List[torch.Tensor], stride: int, size: int) -> torch.Tensor:
    """C(X) = sum_i X^i p_i(X^stride) (reference CPolynomial): p_i's
    coefficients strided into one table, trailing zeros trimmed."""
    dev = polys[0].device
    out = _zeros(stride * size, dev)
    view = out.view(size, stride, bf.N_LIMBS)
    for i, p in enumerate(polys):
        if p.shape[0] > size:
            raise ValueError(f"combine: {p.shape[0]} coefficients > {size}")
        view[:p.shape[0], i] = p
    return _trim(out)


def fflonk_setup(cs: PlonkCS, seed: int = 0, device=None) -> FflonkKey:
    """Dev SRS + C0 commitment (the reference consumes a snarkjs zkey;
    zkey_fflonk.cpp sections map 1:1 onto this structure).  The SRS
    tau^i G1 (i < 9n + 32) is B2's power table through B4, on `device`
    (``None``: the GPU), made affine once (B3's bases)."""
    device = resolve_device(device)
    n = cs.n
    check_domain(n)
    rng = int.from_bytes(keccak256(b"fflonk-dev-srs" + seed.to_bytes(8, "big")), "big")
    tau = rng % FR
    max_deg = 9 * n + 32
    tau_pows = bf.from_mont(CTX, bn254_cuda.powers(tau, max_deg, device=device))
    srs = msm.affine_bases(curve.F1, curve.scalar_mul_words(
        curve.F1, curve.g1_generator(device), tau_pows))
    del tau_pows
    x2 = g2_mul(tau, G2_GEN)

    w = _find_w(n)
    sels = {k: poly_from_evals(fr_tensor(getattr(cs, k), device))
            for k in SELECTORS}
    # sigma polys: slot value maps through k1/k2 cosets
    ids = torch.cat([bn254_cuda.powers(w, n, start=s, device=device)
                     for s in (1, K1, K2)])
    sig_evals = ids[torch.from_numpy(cs.sigma).to(device)]
    del ids
    sigmas = [poly_from_evals(sig_evals[col * n:(col + 1) * n].contiguous())
              for col in range(3)]
    del sig_evals
    c0 = _combine([sels["qL"], sels["qR"], sels["qM"], sels["qO"],
                   sels["qC"], sigmas[0], sigmas[1], sigmas[2]], 8, n)
    return FflonkKey(cs=cs, srs_g1=srs, x2=x2, C0=_commit(srs, c0),
                     c0_coefs=c0, sel_coefs=sels, sigma_coefs=sigmas, w=w)


# ---------------------------------------------------------------------------
# Prover (reference rounds 1-5)
# ---------------------------------------------------------------------------


def _wire(vals, n: int, blind: Tuple[int, int], device) -> torch.Tensor:
    """A wire's n evaluations, Montgomery: the values, zeros, and the
    blinding at rows n-2 and n-1."""
    limbs = np.zeros((n, bf.N_LIMBS), dtype=np.uint64)
    v = _limbs(vals)
    limbs[:v.shape[0]] = v
    limbs[n - 2:] = bf.ints_to_limbs(list(blind))
    return fr_tensor(limbs, device)


def _root_sets(xi_seed: int, w: int, n: int):
    xs2 = xi_seed * xi_seed % FR
    w8 = _find_w(8)
    w4_ = _find_w(4)
    w3 = pow(5, (FR - 1) // 3, FR)
    h0 = [xs2 * xi_seed % FR]
    for i in range(1, 8):
        h0.append(h0[0] * pow(w8, i, FR) % FR)
    h1 = [h0[0] * h0[0] % FR]
    for i in range(1, 4):
        h1.append(h1[0] * pow(w4_, i, FR) % FR)
    h2 = [h1[0] * xs2 % FR]
    h2 += [h2[0] * w3 % FR, h2[0] * w3 % FR * w3 % FR]
    # wr: cube root of w so that h3^3 = xi*w (reference zkey->wr); the
    # domain root w has 2-power order n, and 3 is invertible mod n
    wr = pow(w, pow(3, -1, n), FR)
    h3 = [h2[0] * wr % FR]
    h3 += [h3[0] * w3 % FR, h3[0] * w3 % FR * w3 % FR]
    xi = h2[0] * h2[0] % FR * h2[0] % FR
    return h0, h1, h2, h3, xi


def fflonk_prove(key: FflonkKey, a_vals, b_vals, c_vals,
                 rand: Optional[bytes] = None) -> Dict:
    """The JAX fflonk_prove's proof, on the key's device.  The wire values
    are python ints or (m, 4) uint64 plain canonical limbs."""
    cs, n, w = key.cs, key.cs.n, key.w
    dev = key.device
    check_domain(n)
    # rows n-2/n-1 are overwritten with blinding below; they must be
    # selector-free, copy-free padding (r1cs_to_plonk reserves them)
    for name in SELECTORS:
        sel = getattr(cs, name)
        assert not sel[n - 2:].any(), f"blinding rows carry live selector {name}"
    for col in range(3):
        for row in (n - 2, n - 1):
            assert cs.sigma[col * n + row] == col * n + row, (
                "blinding rows participate in a copy cycle")
    assert len(a_vals) <= n - 2 and len(b_vals) <= n - 2 and \
        len(c_vals) <= n - 2, "wire values extend into the blinding rows"
    rnd = rand or os.urandom(32 * 10)
    b = [0] + [int.from_bytes(keccak256(rnd + bytes([i])), "big") % FR
               for i in range(1, 10)]

    # ---- round 1: wire polys + T0 + C1 (:635-815) ----
    bufA = _wire(a_vals, n, (b[2], b[1]), dev)
    bufB = _wire(b_vals, n, (b[4], b[3]), dev)
    bufC = _wire(c_vals, n, (b[6], b[5]), dev)
    publics = fr_ints(bufA[:cs.n_public])
    A = poly_from_evals(bufA)
    B = poly_from_evals(bufB)
    C = poly_from_evals(bufC)

    n4 = 4 * n
    # the public-input term -sum_j a_j L_j, one polynomial extended once
    pi = _zeros(n, dev)
    if cs.n_public:
        pi[:cs.n_public] = fr_tensor([-v for v in publics], dev)
    cols = {"a": poly_extend_evals(A, n4), "b": poly_extend_evals(B, n4),
            "c": poly_extend_evals(C, n4),
            "pi": poly_extend_evals(poly_from_evals(pi), n4)}
    for k in SELECTORS:
        cols[k.lower()] = poly_extend_evals(key.sel_coefs[k], n4)
    (t0_ev,) = ffk.quotient(0, cols)
    del cols, pi
    T0 = poly_div_zerofier(poly_from_evals(t0_ev), n, 1)
    del t0_ev
    C1_coefs = _combine([A, B, C, T0], 4, 2 * n)
    del T0
    C1 = _commit(key.srs_g1, C1_coefs)

    # ---- round 2: beta/gamma, Z, T1, T2, C2 (:817-1150) ----
    tr = KeccakTranscript()
    tr.add_point(key.C0)
    for v in publics:
        tr.add_scalar(v)
    tr.add_point(C1)
    beta = tr.get_challenge()
    tr.reset()
    tr.add_scalar(beta)
    gamma = tr.get_challenge()

    sig_ev4 = [poly_extend_evals(s, n4) for s in key.sigma_coefs]
    # the n-domain sigmas are every fourth 4n evaluation, read in place
    num, den = ffk.quotient(
        1, {"a": bufA, "b": bufB, "c": bufC, "s1": sig_ev4[0][::4],
            "s2": sig_ev4[1][::4], "s3": sig_ev4[2][::4]},
        root=w, beta=beta, gamma=gamma)
    del bufA, bufB, bufC
    # z_{i+1} = prod_{j <= i} num_j / prod_{j <= i} den_j: F1's prefix
    # products, F2's inverses
    ratio = bn254_cuda.mont_mul(CTX, ffk.scan(num, 1, "mul"),
                                ffk.inv(ffk.scan(den, 1, "mul")))
    del num, den
    if fr_ints(ratio[n - 1:])[0] != 1:
        raise ValueError("copy constraints do not match")
    z_ev = torch.cat([bf.mont_one(CTX, (1,), dev), ratio[:n - 1]])
    del ratio
    Z = poly_from_evals(z_ev)
    del z_ev
    # blind z: z += (b7 X^2 + b8 X + b9) * Z_H
    Z = torch.cat([Z, fr_tensor([b[9], b[8], b[7]], dev)])
    Z = _add_small(Z, [-b[9], -b[8], -b[7]])

    # T1 := (z - 1) L1 / ZH and T2 on the 4n domain (:980-1131): (z - 1) L1
    # has degree 2n + 1 with z blinded as a polynomial.  The wires' 4n
    # evaluations are extended again here (freed after round 1).
    e0 = _zeros(n, dev)
    e0[0] = bf.mont_one(CTX, (), dev)
    cols = {"a": poly_extend_evals(A, n4), "b": poly_extend_evals(B, n4),
            "c": poly_extend_evals(C, n4), "s1": sig_ev4[0],
            "s2": sig_ev4[1], "s3": sig_ev4[2],
            "z": poly_extend_evals(Z, n4),
            "l1": poly_extend_evals(poly_from_evals(e0), n4)}
    del sig_ev4, A, B, C
    t1_ev, t2_ev = ffk.quotient(2, cols, root=_find_w(n4), beta=beta,
                                gamma=gamma, shift=4)
    del cols
    T1 = poly_div_zerofier(poly_from_evals(t1_ev), n, 1)
    del t1_ev
    T2 = poly_div_zerofier(poly_from_evals(t2_ev), n, 1)
    del t2_ev
    C2_coefs = _combine([Z, T1, T2], 3, 3 * n + 3)
    del Z, T1, T2
    C2 = _commit(key.srs_g1, C2_coefs)

    # ---- round 3: xi + evaluations (:1153-1238) ----
    tr.reset()
    tr.add_scalar(gamma)
    tr.add_point(C2)
    xi_seed = tr.get_challenge()
    h0, h1, h2, h3, xi = _root_sets(xi_seed, w, n)

    # a, b, c and z, T1, T2 are read back from C1 and C2 (strided)
    evals = {
        "ql": poly_eval(key.sel_coefs["qL"], xi),
        "qr": poly_eval(key.sel_coefs["qR"], xi),
        "qm": poly_eval(key.sel_coefs["qM"], xi),
        "qo": poly_eval(key.sel_coefs["qO"], xi),
        "qc": poly_eval(key.sel_coefs["qC"], xi),
        "s1": poly_eval(key.sigma_coefs[0], xi),
        "s2": poly_eval(key.sigma_coefs[1], xi),
        "s3": poly_eval(key.sigma_coefs[2], xi),
        "a": poly_eval(C1_coefs[0::4], xi),
        "b": poly_eval(C1_coefs[1::4], xi),
        "c": poly_eval(C1_coefs[2::4], xi),
        "z": poly_eval(C2_coefs[0::3], xi),
    }
    xiw = xi * w % FR
    evals["zw"] = poly_eval(C2_coefs[0::3], xiw)
    evals["t1w"] = poly_eval(C2_coefs[1::3], xiw)
    evals["t2w"] = poly_eval(C2_coefs[2::3], xiw)

    # ---- round 4: alpha, R0/R1/R2, F, W1 (:1241-1420) ----
    tr.reset()
    tr.add_scalar(xi_seed)
    for k in EVAL_KEYS:
        tr.add_scalar(evals[k])
    alpha = tr.get_challenge()

    R0 = lagrange_interp(h0, [poly_eval(key.c0_coefs, x) for x in h0])
    R1 = lagrange_interp(h1, [poly_eval(C1_coefs, x) for x in h1])
    R2 = lagrange_interp(h2 + h3, [poly_eval(C2_coefs, x) for x in h2 + h3])

    alpha2 = alpha * alpha % FR
    F = _add_small(poly_mul_scalar(C2_coefs, alpha2),
                   [-v * alpha2 for v in R2])
    F = poly_div_zerofier(poly_div_zerofier(F, 3, xi), 3, xiw)
    f1 = poly_div_zerofier(_add_small(poly_mul_scalar(C1_coefs, alpha),
                                      [-v * alpha for v in R1]), 4, xi)
    f0 = poly_div_zerofier(_add_small(key.c0_coefs, [-v for v in R0]), 8, xi)
    F = poly_sum([F, f1, f0])
    del f0, f1
    W1 = _commit(key.srs_g1, F)

    # ---- round 5: y, L, W2 (:1420-1560) ----
    tr.reset()
    tr.add_scalar(alpha)
    tr.add_point(W1)
    y = tr.get_challenge()

    mulL0 = 1
    for x in h0:
        mulL0 = mulL0 * (y - x) % FR
    mulL1 = 1
    for x in h1:
        mulL1 = mulL1 * (y - x) % FR
    mulL2 = 1
    for x in h2 + h3:
        mulL2 = mulL2 * (y - x) % FR
    preL0 = mulL1 * mulL2 % FR
    preL1 = alpha * mulL0 % FR * mulL2 % FR
    preL2 = alpha2 * mulL0 % FR * mulL1 % FR

    # L = ((C2 - r2(y)) preL2 + (C1 - r1(y)) preL1 + (C0 - r0(y)) preL0
    #      - ZT(y) F) / ZTS2(y)
    zt_y = poly_eval(poly_zerofier(h0 + h1 + h2 + h3), y)
    s = _inv(poly_eval(poly_zerofier(h1 + h2 + h3), y))
    L = poly_sum([C2_coefs, C1_coefs, key.c0_coefs, F],
                 [preL2 * s, preL1 * s, preL0 * s, -zt_y * s])
    del F, C1_coefs, C2_coefs
    r_y = (poly_eval(R2, y) * preL2 + poly_eval(R1, y) * preL1
           + poly_eval(R0, y) * preL0) % FR
    L = _add_small(L, [-r_y * s])
    W2 = _commit(key.srs_g1, poly_div_zerofier(L, 1, y))

    return {
        "protocol": "fflonk",
        "C1": C1, "C2": C2, "W1": W1, "W2": W2,
        "evals": evals,
        "publics": publics,
    }


# ---------------------------------------------------------------------------
# Verifier (snarkjs fflonk_verify role — the CI acceptance step); host
# python ints, as in the JAX package
# ---------------------------------------------------------------------------


def fflonk_verify(key: FflonkKey, proof: Dict) -> bool:
    cs, n, w = key.cs, key.cs.n, key.w
    ev = proof["evals"]
    publics = [int(x) % FR for x in proof["publics"]]
    C1, C2, W1, W2 = (proof["C1"], proof["C2"], proof["W1"], proof["W2"])
    for p in (C1, C2, W1, W2):
        if p is None or (p[1] * p[1] - p[0] ** 3 - 3) % Q != 0:
            return False

    # replay the transcript
    tr = KeccakTranscript()
    tr.add_point(key.C0)
    for v in publics:
        tr.add_scalar(v)
    tr.add_point(C1)
    beta = tr.get_challenge()
    tr.reset()
    tr.add_scalar(beta)
    gamma = tr.get_challenge()
    tr.reset()
    tr.add_scalar(gamma)
    tr.add_point(C2)
    xi_seed = tr.get_challenge()
    h0, h1, h2, h3, xi = _root_sets(xi_seed, w, cs.n)
    xiw = xi * w % FR

    tr.reset()
    tr.add_scalar(xi_seed)
    for k in EVAL_KEYS:
        tr.add_scalar(ev[k])
    alpha = tr.get_challenge()
    tr.reset()
    tr.add_scalar(alpha)
    tr.add_point(W1)
    y = tr.get_challenge()

    # derive t0/t1/t2 at xi from the committed evaluations (verifier
    # steps 6-8: the identities hold iff these are the Ti openings)
    zh = (pow(xi, n, FR) - 1) % FR
    lag1 = (pow(xi, n, FR) - 1) * _inv(n * (xi - 1) % FR) % FR
    pi_xi = 0
    wk = 1
    for j, pub in enumerate(publics):
        lj = (pow(xi, n, FR) - 1) * wk % FR * _inv(n * (xi - wk) % FR) % FR
        pi_xi = (pi_xi - lj * pub) % FR
        wk = wk * w % FR
    t0 = (ev["ql"] * ev["a"] + ev["qr"] * ev["b"]
          + ev["qm"] * ev["a"] % FR * ev["b"]
          + ev["qo"] * ev["c"] + ev["qc"] + pi_xi) % FR * _inv(zh) % FR
    t1 = (ev["z"] - 1) * lag1 % FR * _inv(zh) % FR
    e1 = ((ev["a"] + beta * xi + gamma)
          * (ev["b"] + K1 * beta % FR * xi + gamma) % FR
          * (ev["c"] + K2 * beta % FR * xi + gamma) % FR * ev["z"]) % FR
    e2 = ((ev["a"] + beta * ev["s1"] + gamma)
          * (ev["b"] + beta * ev["s2"] + gamma) % FR
          * (ev["c"] + beta * ev["s3"] + gamma) % FR * ev["zw"]) % FR
    t2 = (e1 - e2) % FR * _inv(zh) % FR

    # rebuild R0/R1/R2 openings from the evaluation set
    c0_at = lambda x: (ev["ql"] + x * ev["qr"] + pow(x, 2, FR) * ev["qm"]  # noqa: E731
                       + pow(x, 3, FR) * ev["qo"] + pow(x, 4, FR) * ev["qc"]
                       + pow(x, 5, FR) * ev["s1"] + pow(x, 6, FR) * ev["s2"]
                       + pow(x, 7, FR) * ev["s3"]) % FR
    c1_at = lambda x: (ev["a"] + x * ev["b"] + pow(x, 2, FR) * ev["c"]  # noqa: E731
                       + pow(x, 3, FR) * t0) % FR
    c2_at = lambda x: (ev["z"] + x * t1 + pow(x, 2, FR) * t2) % FR  # noqa: E731
    c2w_at = lambda x: (ev["zw"] + x * ev["t1w"]  # noqa: E731
                        + pow(x, 2, FR) * ev["t2w"]) % FR
    R0 = lagrange_interp(h0, [c0_at(x) for x in h0])
    R1 = lagrange_interp(h1, [c1_at(x) for x in h1])
    R2 = lagrange_interp(h2 + h3, [c2_at(x) for x in h2]
                         + [c2w_at(x) for x in h3])

    mulL0 = 1
    for x in h0:
        mulL0 = mulL0 * (y - x) % FR
    mulL1 = 1
    for x in h1:
        mulL1 = mulL1 * (y - x) % FR
    mulL2 = 1
    for x in h2 + h3:
        mulL2 = mulL2 * (y - x) % FR
    alpha2 = alpha * alpha % FR
    preL0 = mulL1 * mulL2 % FR
    preL1 = alpha * mulL0 % FR * mulL2 % FR
    preL2 = alpha2 * mulL0 % FR * mulL1 % FR

    # [L']_1 = preL0 (C0 - r0(y) G) + preL1 (C1 - r1(y) G)
    #        + preL2 (C2 - r2(y) G) - ZT(y) W1
    zt_y = poly_eval(poly_zerofier(h0 + h1 + h2 + h3), y)
    zts2_y = poly_eval(poly_zerofier(h1 + h2 + h3), y)
    acc = g1_mul(preL0, key.C0)
    acc = g1_add(acc, g1_mul(preL1, C1))
    acc = g1_add(acc, g1_mul(preL2, C2))
    s = (preL0 * poly_eval(R0, y) + preL1 * poly_eval(R1, y)
         + preL2 * poly_eval(R2, y)) % FR
    acc = g1_add(acc, g1_neg(g1_mul(s, G1_GEN)))
    acc = g1_add(acc, g1_neg(g1_mul(zt_y, W1)))
    # L'(X) = zts2(y) * W2(X) * (X - y)
    #   e(L' + y*zts2(y)*W2, [1]_2) == e(zts2(y)*W2, [tau]_2)
    lhs = g1_add(acc, g1_mul(y * zts2_y % FR, W2))
    rhs_pt = g1_mul(zts2_y, W2)
    out = multi_pairing([
        (G2_GEN, lhs),
        (key.x2, g1_neg(rhs_pt)),
    ])
    return out == F12_ONE
