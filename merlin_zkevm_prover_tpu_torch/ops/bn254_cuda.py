"""Elementwise BN254 Montgomery kernels (part of kernel B2, in
``csrc/bn254_ntt.cu``) and their plain twins.

``mont_mul``   a * b / 2^256 over Fq or Fr, b broadcast when it is one
    element: the coset scale, the inverse transform's 1/n, the conversions
    into and out of Montgomery form (``bn254_field.to_mont``/``from_mont``)
    and the pointwise products of the Groth16 prover.
``mul_sub``    a * b - c over Fr: Groth16's H values on the coset.
``powers``     start * base^i for i < n over Fr: twiddle and coset tables,
    the setup's domains, fflonk's row powers; a thread makes 64 of them,
    one product each after the first (``BN_POWERS_RUN``).
``poly_eval``  sum_i c_i x^i over Fr in one launch: the powers made as
    ``powers`` makes them and never written, the products summed in each
    block, the blocks' sums by the block that finishes last.

Each takes the plain twin only for a CPU tensor; on a CUDA tensor it
launches its kernel or raises.  ``LAUNCHES`` counts kernel launches and
``SHAPES`` records them by shape.  The
reference computes the same values with ``bf.mont_mul`` / ``bf.sub`` over
16-bit limbs (``snark/fft.py``, ``snark/groth16.py``) and host python ints
(the power tables).
"""

from __future__ import annotations

import ctypes

import torch

from . import bn254_field as bf
from . import cuda_build
from .bn254_field import FR, FpCtx
from .goldilocks import resolve_device

LAUNCHES = {"mont_mul": 0, "mul_sub": 0, "powers": 0, "poly_eval": 0}
# launches by shape: mont_mul (field, n, b one element), mul_sub n,
# powers (base, n, start), poly_eval (m, rows apart)
SHAPES: dict = {}

_vp = ctypes.c_void_p


def _check(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.int64 or t.shape[-1] != bf.N_LIMBS:
        raise TypeError(f"{name}: expected (..., 4) int64 limbs, got "
                        f"{t.dtype} {tuple(t.shape)}")


def mont_mul_plain(ctx: FpCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return bf.from16(bf.mul16(ctx, bf.to16(a), bf.to16(b)))


def mont_mul(ctx: FpCtx, a: torch.Tensor, b: torch.Tensor,
             out: torch.Tensor = None) -> torch.Tensor:
    """(..., 4) a times b of a's shape or one (4,) element; into `out` (a
    contiguous tensor of a's shape, which may be `a`) when given."""
    if not a.is_cuda:
        res = mont_mul_plain(ctx, a, b)
        return res if out is None else out.copy_(res)
    _check(a, "mont_mul")
    _check(b, "mont_mul")
    a = a.contiguous()
    if b.shape != a.shape and b.numel() != bf.N_LIMBS:
        b = b.expand(a.shape)
    b = b.contiguous()
    if out is None:
        out = torch.empty_like(a)
    elif out.shape != a.shape or not out.is_contiguous():
        raise ValueError("mont_mul: out must be contiguous, of a's shape")
    n = a.numel() // bf.N_LIMBS
    if n == 0:
        return out
    stride = 0 if b.numel() == bf.N_LIMBS else 1
    cuda_build.check(cuda_build.lib().merlin_bn_mont_mul(
        0 if ctx is bf.FQ else 1, _vp(a.data_ptr()), _vp(b.data_ptr()), n,
        stride, _vp(out.data_ptr()), _vp(cuda_build.stream_ptr())),
        "bn254 mont_mul")
    cuda_build.count(LAUNCHES, SHAPES, "mont_mul",
                     (ctx.name, n, b.numel() == bf.N_LIMBS))
    return out


def mul_sub_plain(a, b, c):
    return bf.from16(bf.sub16(FR, bf.mul16(FR, bf.to16(a), bf.to16(b)),
                              bf.to16(c)))


def mul_sub(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b - c over Fr, (n, 4) each."""
    if not a.is_cuda:
        return mul_sub_plain(a, b, c)
    for t in (a, b, c):
        _check(t, "mul_sub")
    a, b, c = a.contiguous(), b.contiguous(), c.contiguous()
    out = torch.empty_like(a)
    n = a.numel() // bf.N_LIMBS
    if n == 0:
        return out
    cuda_build.check(cuda_build.lib().merlin_bn_fr_mul_sub(
        _vp(a.data_ptr()), _vp(b.data_ptr()), _vp(c.data_ptr()), n,
        _vp(out.data_ptr()), _vp(cuda_build.stream_ptr())), "bn254 mul_sub")
    cuda_build.count(LAUNCHES, SHAPES, "mul_sub", n)
    return out


def powers_plain(base: int, n: int, start: int = 1, device=None) -> torch.Tensor:
    """Montgomery-form (n, 4): start * base^i over Fr, by doubling the
    table (log2 n batched products)."""
    out = bf.ints_to16(FR, [start], device)
    step = bf.const16(FR, base, device)
    while out.shape[0] < n:
        out = torch.cat([out, bf.mul16(FR, out, step)])
        step = bf.sqr16(FR, step)
    return bf.from16(out[:n])


def square_ints(base: int, n: int) -> list:
    """base^(2^i) over Fr for i below the bit length of n - 1 (at least one
    entry): the table a run of powers starts from (a thread's first power
    by square-and-multiply over its index's bits)."""
    vals, b = [], base % FR.mod
    for _ in range(max(1, (n - 1).bit_length())):
        vals.append(b)
        b = b * b % FR.mod
    return vals


def _square_table(base: int, n: int, device) -> torch.Tensor:
    """square_ints(base, n), Montgomery, on `device`."""
    return bf.from_int(FR, square_ints(base, n), device)


def powers(base: int, n: int, start: int = 1, device=None) -> torch.Tensor:
    """start * base^i over Fr for i < n, Montgomery form, on `device`
    (``None``: the GPU)."""
    device = resolve_device(device)
    if device.type != "cuda":
        return powers_plain(base, n, start, device)
    out = torch.empty((n, bf.N_LIMBS), dtype=torch.int64, device=device)
    if n == 0:
        return out
    lib = cuda_build.lib()
    sq = _square_table(base, n, device)
    s = bf.const(FR, start, device)
    # a thread's powers lie a block apart
    step = bf.const(FR, pow(base, lib.merlin_bn_fr_run_threads(), FR.mod),
                    device)
    cuda_build.check(lib.merlin_bn_fr_powers(
        _vp(sq.data_ptr()), _vp(s.data_ptr()), _vp(step.data_ptr()), n,
        _vp(out.data_ptr()), _vp(cuda_build.stream_ptr())), "bn254 powers")
    cuda_build.count(LAUNCHES, SHAPES, "powers", (base, n, start))
    return out


def _sum_plain(v: torch.Tensor) -> torch.Tensor:
    """The sum of the rows of a (m, 16) plain-form Fr tensor, (1, 16): a
    tree of pairs."""
    while v.shape[0] > 1:
        half = v.shape[0] // 2
        s = bf.add16(FR, v[:half], v[half:2 * half])
        v = torch.cat([s, v[2 * half:]]) if v.shape[0] % 2 else s
    return v


def poly_eval_plain(coefs: torch.Tensor, x: int) -> torch.Tensor:
    """sum_i c_i x^i, Montgomery (4,): ``mont_mul_plain`` of the
    coefficients and ``powers_plain``, summed."""
    m = coefs.shape[0]
    if m == 0:
        return torch.zeros(bf.N_LIMBS, dtype=torch.int64, device=coefs.device)
    prods = mont_mul_plain(FR, coefs, powers_plain(x % FR.mod, m,
                                                   device=coefs.device))
    return bf.from16(_sum_plain(bf.to16(prods)))[0]


def poly_eval(coefs: torch.Tensor, x: int) -> torch.Tensor:
    """sum_i c_i x^i over Fr for (m, 4) Montgomery coefficients (rows may
    lie any fixed distance apart, as a strided slice's do), Montgomery
    (4,): one launch, no power table written."""
    if not coefs.is_cuda:
        return poly_eval_plain(coefs, x)
    _check(coefs, "poly_eval")
    m = coefs.shape[0]
    dev = coefs.device
    out = torch.zeros(bf.N_LIMBS, dtype=torch.int64, device=dev)
    if m == 0:
        return out
    if coefs.stride(1) != 1:
        coefs = coefs.contiguous()
    x %= FR.mod
    lib = cuda_build.lib()
    sq = _square_table(x, m, dev)
    step = bf.const(FR, pow(x, lib.merlin_bn_fr_run_threads(), FR.mod), dev)
    partials = torch.empty((lib.merlin_bn_fr_poly_eval_blocks(m), bf.N_LIMBS),
                           dtype=torch.int64, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    cuda_build.check(lib.merlin_bn_fr_poly_eval(
        _vp(coefs.data_ptr()), coefs.stride(0), m, _vp(sq.data_ptr()),
        _vp(step.data_ptr()), _vp(partials.data_ptr()),
        _vp(counter.data_ptr()), _vp(out.data_ptr()),
        _vp(cuda_build.stream_ptr())), "bn254 poly_eval")
    cuda_build.count(LAUNCHES, SHAPES, "poly_eval",
                     (m, coefs.stride(0) // bf.N_LIMBS))
    return out
