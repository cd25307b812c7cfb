"""Development trusted setup (test/dev-mode zkey generation).

The reference consumes externally produced .zkey artifacts (prover.cpp:68).
This module generates a structurally identical proving key for any R1CS
from explicit toxic-waste scalars — for tests (the known dlogs let tests
check every proof point exactly in the exponent, no pairings needed) and
for dev-mode end-to-end runs.

The same key as the JAX package's ``setup`` from the same seed: the same
scalars, computed on the key's device (the reference loops over the domain
in python, two modular ``pow`` inverses a point, and over every
coefficient; here the domain points come from the power kernel, the
inverses from elementwise exponentiation, the per-signal sums from the
products of kernel B2 and the range sums of B3's ``msm.sum_by_key``), the
same points (kernel B4 on the
card, its twin on the CPU), the tables made affine once (B3's
``msm.affine_bases``: the bases of the prover's MSMs).  The coefficient
table is kept as columns on the device (``Coefs``).
"""

from __future__ import annotations

import contextlib
import itertools
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import bn254_cuda
from ..ops import bn254_field as bf
from ..ops.bn254_field import FR
from ..ops.goldilocks import resolve_device
from ..utils.timer import TimerLog
from . import curve, fft, msm
from .curve import F1, F2


@dataclass
class R1CS:
    """Constraints: for each c, (sum A[c]) * (sum B[c]) = (sum C[c]).

    a/b/c: list over constraints of {signal: coef} dicts.
    witness layout: [1, publics..., privates...].
    """

    n_vars: int
    n_public: int
    a: List[Dict[int, int]]
    b: List[Dict[int, int]]
    c: List[Dict[int, int]]


class Coefs(NamedTuple):
    """The A and B coefficient table, one entry a row, as tensors on the
    key's device: matrix m (0 = A, 1 = B), constraint, signal, and the
    coefficient as plain (E, 4) limbs (reduced mod r where it is read)."""

    m: torch.Tensor
    c: torch.Tensor
    s: torch.Tensor
    value: torch.Tensor

    def as_list(self) -> List[Tuple[int, int, int, int]]:
        """The reference's (m, c, s, value mod r) tuples, in its order (by
        constraint, A's entries before B's)."""
        m, c, s = (t.cpu().numpy() for t in (self.m, self.c, self.s))
        vals = bf.limbs_to_ints(self.value)
        order = np.lexsort((np.arange(len(vals)), m, c))
        return [(int(m[k]), int(c[k]), int(s[k]), vals[k] % FR.mod)
                for k in order]

    @staticmethod
    def from_list(rows, device=None) -> "Coefs":
        rows = list(rows)
        cols = [torch.tensor([r[i] for r in rows], dtype=torch.int64,
                             device=device) for i in range(3)]
        return Coefs(*cols, bf.from_u64(bf.ints_to_limbs(
            [int(r[3]) % FR.mod for r in rows]), device))

    def __len__(self) -> int:
        return int(self.m.shape[0])


def _matrix_columns(rows: List[Dict[int, int]], device):
    """(constraint, signal, coefficient limbs) of one matrix, on `device`.
    A final R1CS holds some 10^8 entries but a few thousand distinct
    coefficients, so each distinct one is converted once and gathered.
    The coefficients are read as they are: the kernels reduce them."""
    lens = np.fromiter(map(len, rows), dtype=np.int64, count=len(rows))
    n = int(lens.sum())
    cons = np.repeat(np.arange(len(rows), dtype=np.int64), lens)
    sig = np.fromiter(itertools.chain.from_iterable(rows), dtype=np.int64,
                      count=n)
    uniq: Dict[int, int] = {}
    which = np.fromiter(
        (uniq.setdefault(v, len(uniq)) for v in
         itertools.chain.from_iterable(lc.values() for lc in rows)),
        dtype=np.int64, count=n)
    table = bf.from_u64(bf.ints_to_limbs(list(uniq)), device)
    return (torch.from_numpy(cons).to(device), torch.from_numpy(sig).to(device),
            table[torch.from_numpy(which).to(device)])


def coef_table(r1cs: R1CS, device=None, cols_a=None, cols_b=None) -> Coefs:
    ca, sa, va = cols_a or _matrix_columns(r1cs.a, device)
    cb, sb, vb = cols_b or _matrix_columns(r1cs.b, device)
    m = torch.cat([torch.zeros_like(ca), torch.ones_like(cb)])
    return Coefs(m, torch.cat([ca, cb]), torch.cat([sa, sb]),
                 torch.cat([va, vb]))


class FrVector:
    """A Montgomery-form (n, 4) tensor read as a sequence of python ints
    (the toxic waste's u, v, w: make_vk reads a few of them)."""

    def __init__(self, t: torch.Tensor):
        self.t = t

    def __len__(self) -> int:
        return int(self.t.shape[0])

    def __getitem__(self, i):
        if isinstance(i, slice):
            return list(bf.to_int(FR, self.t[i]))
        return int(bf.to_int(FR, self.t[i:i + 1])[0]) if i >= 0 else \
            self[len(self) + i]

    def __iter__(self):
        return iter(bf.to_int(FR, self.t).tolist())


def _inv_diff(tau: int, xs: torch.Tensor) -> torch.Tensor:
    """1 / (tau - x) for Montgomery xs (Fermat, elementwise: the
    reference's pow per point; 0 maps to 0)."""
    n = xs.shape[0]
    dev = xs.device
    minus_one = bf.const(FR, FR.mod - 1, dev).expand(n, bf.N_LIMBS)
    minus_tau = bf.const(FR, -tau, dev).expand(n, bf.N_LIMBS)
    return bf.inv(FR, bn254_cuda.mul_sub(xs, minus_one, minus_tau))


def lagrange_evals(tau: int, n: int, device=None) -> torch.Tensor:
    """L_i(tau) = z w^i / (n (tau - w^i)) for the size-n FFT domain,
    Montgomery (n, 4) on `device`."""
    mod = FR.mod
    xs = bn254_cuda.powers(fft.w_fr(n.bit_length() - 1), n, device=device)
    k = (pow(tau, n, mod) - 1) * pow(n, mod - 2, mod) % mod
    return bn254_cuda.mont_mul(FR, bn254_cuda.mont_mul(
        FR, xs, _inv_diff(tau, xs)), bf.const(FR, k, xs.device))


def h_point_scalars(tau: int, domain_bits: int, dinv: int, device=None
                    ) -> torch.Tensor:
    """The H points' scalars of the reference's setup (setup.py:97-115),
    Montgomery (2^domain_bits, 4): with x_k = eta w^k on the odd coset,
    x_k^n = eta^n for every k, so L^coset_k(tau) Z(tau) / (Z(x_k) delta)
    = K x_k / (tau - x_k)."""
    mod = FR.mod
    n = 1 << domain_bits
    eta = fft.w_fr(domain_bits + 1)
    xs = bn254_cuda.powers(fft.w_fr(domain_bits), n, start=eta, device=device)
    eta_n = pow(eta, n, mod)
    z_tau = (pow(tau, n, mod) - 1) % mod
    zc_tau = (pow(tau, n, mod) + 1) % mod
    k = (zc_tau * pow(n, mod - 2, mod) % mod * pow(eta_n, mod - 2, mod) % mod
         * z_tau % mod * pow((eta_n - 1) % mod, mod - 2, mod) % mod
         * dinv % mod)
    return bn254_cuda.mont_mul(FR, bn254_cuda.mont_mul(
        FR, xs, _inv_diff(tau, xs)), bf.const(FR, k, xs.device))


def _signal_sums(cols, lag: torch.Tensor, n_vars: int) -> torch.Tensor:
    """sum over constraints c of coef * L_c(tau), per signal (Montgomery
    (n_vars, 4)) from one matrix's columns: the products on the card,
    summed by signal."""
    c, s, v = cols
    prods = bn254_cuda.mont_mul(FR, bf.to_mont(FR, v), lag[c])
    return msm.sum_by_key_unsorted(None, prods, s, n_vars)


@contextlib.contextmanager
def _piece(timer: Optional[TimerLog], label: str, device):
    """A span of `timer` (None: no span) that ends when the card has done
    the work the piece queued, so that each piece holds its own host and
    device time."""
    if timer is None:
        yield
        return
    with timer.span(label):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def setup(r1cs: R1CS, tau: int = None, alpha: int = None, beta: int = None,
          delta: int = None, seed: int = 1234, device=None,
          timer: Optional[TimerLog] = None) -> Tuple["Groth16Key", Dict]:
    """Returns (key, toxic) — toxic only for tests/dev.  The points are
    made on `device` (``None``: the GPU).  With `timer`, the spans
    SETUP_LAGRANGE, _COLUMNS (A's and B's), _SUMS, _COEFS, _SCALARS and
    _POINTS split the setup, each ending on a synchronize."""
    import random

    from .groth16 import Groth16Key

    device = resolve_device(device)
    rng = random.Random(seed)
    mod = FR.mod
    tau = tau or rng.randrange(1, mod)
    alpha = alpha or rng.randrange(1, mod)
    beta = beta or rng.randrange(1, mod)
    delta = delta or rng.randrange(1, mod)

    n_cons = len(r1cs.a)
    domain_bits = max((n_cons - 1).bit_length(), 1)
    n = 1 << domain_bits

    with _piece(timer, "SETUP_LAGRANGE", device):
        lag = lagrange_evals(tau, n, device)
    with _piece(timer, "SETUP_COLUMNS", device):
        cols_a = _matrix_columns(r1cs.a, device)
        cols_b = _matrix_columns(r1cs.b, device)
    with _piece(timer, "SETUP_SUMS", device):
        u = _signal_sums(cols_a, lag, r1cs.n_vars)
        v = _signal_sums(cols_b, lag, r1cs.n_vars)
        wv = _signal_sums(_matrix_columns(r1cs.c, device), lag, r1cs.n_vars)
        del lag
    with _piece(timer, "SETUP_COEFS", device):
        coefs = coef_table(r1cs, device, cols_a, cols_b)
        del cols_a, cols_b

    with _piece(timer, "SETUP_SCALARS", device):
        dinv = pow(delta, mod - 2, mod)
        priv = slice(r1cs.n_public + 1, r1cs.n_vars)
        c_scalars = bf.from_mont(FR, bn254_cuda.mont_mul(FR, bf.add(
            FR, bf.add(FR, bn254_cuda.mont_mul(FR, u[priv],
                                               bf.const(FR, beta, device)),
                       bn254_cuda.mont_mul(FR, v[priv],
                                           bf.const(FR, alpha, device))),
            wv[priv]), bf.const(FR, dinv, device)))
        h_scalars = bf.from_mont(FR, h_point_scalars(tau, domain_bits, dinv,
                                                     device))
        u_plain, v_plain = bf.from_mont(FR, u), bf.from_mont(FR, v)

    with _piece(timer, "SETUP_POINTS", device):
        g1 = curve.g1_generator(device)
        g2 = curve.g2_generator(device)

        def table(F, base, scalars):
            return msm.affine_bases(F, curve.scalar_mul_words(F, base, scalars))

        key = Groth16Key(
            n_vars=r1cs.n_vars,
            n_public=r1cs.n_public,
            domain_bits=domain_bits,
            coefs=coefs,
            vk_alpha1=curve.scalar_mul(F1, g1, alpha),
            vk_beta1=curve.scalar_mul(F1, g1, beta),
            vk_delta1=curve.scalar_mul(F1, g1, delta),
            vk_beta2=curve.scalar_mul(F2, g2, beta),
            vk_delta2=curve.scalar_mul(F2, g2, delta),
            points_a=table(F1, g1, u_plain),
            points_b1=table(F1, g1, v_plain),
            points_b2=table(F2, g2, v_plain),
            points_c=table(F1, g1, c_scalars) if c_scalars.shape[0] else None,
            points_h=table(F1, g1, h_scalars),
        )
    toxic = {"tau": tau, "alpha": alpha, "beta": beta, "delta": delta,
             "u": FrVector(u), "v": FrVector(v), "w": FrVector(wv)}
    return key, toxic
