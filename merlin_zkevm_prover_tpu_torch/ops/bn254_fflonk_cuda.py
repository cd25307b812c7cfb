"""Kernels F1-F3 of the fflonk prover (``csrc/bn254_fflonk.cu``) and their
plain twins.

``scan``      F1: inclusive scan over Fr, by addition or multiplication, of
    ``k`` interleaved chains (element i in chain i mod k), forwards or
    backwards: division by ``X^k - beta``, the grand product's prefix
    products, sums of stacked polynomials (``snark/fflonk.py``).
``inv``       F2: elementwise inverse (0 for 0) by Montgomery's batch
    trick: a thread's run of elements a block apart, a product tree in
    shared memory, one inversion a block (binary extended Euclid).
``quotient``  F3: the quotient numerators on a domain, one kernel a part:
    part 0 ``t0``, part 1 the grand product's factors ``num`` and ``den``,
    part 2 ``t1`` and ``t2`` (the JAX package's loops at
    ``snark/fflonk.py:326-332, 352-367, 383-399``); a thread takes a run
    of points a block apart, X = root^i one product a point after the
    run's first (``power_runs_plain`` is that schedule in plain torch).

Elements are Montgomery ``(m, 4)`` int64 tensors (``ops/bn254_field.py``);
constants are python ints.  Each wrapper takes its plain twin only for a
CPU tensor; on a CUDA tensor it launches its kernel or raises.
``LAUNCHES`` counts kernel launches and ``SHAPES`` records them by shape:
scan and scan_carry ``(length, k, op, backward)``, inv ``n``, quotient
``(part, n)``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import bn254_cuda
from . import bn254_field as bf
from . import cuda_build
from .bn254_field import FR

LAUNCHES = {"scan": 0, "scan_carry": 0, "inv": 0, "quotient": 0}
SHAPES: dict = {}

OPS = ("add", "mul")
QUOTIENT_COLUMNS = ("a", "b", "c", "ql", "qr", "qm", "qo", "qc", "s1", "s2",
                    "s3", "z", "l1", "pi")
# the columns each part reads, and how many outputs it writes
PART_COLUMNS = {0: ("a", "b", "c", "ql", "qr", "qm", "qo", "qc", "pi"),
                1: ("a", "b", "c", "s1", "s2", "s3"),
                2: ("a", "b", "c", "s1", "s2", "s3", "z", "l1")}
PART_OUTPUTS = {0: 1, 1: 2, 2: 2}
K1 = 2
K2 = 3
TWO_ADICITY = 28   # QuotientArgs.sq's rows (Fr's two-adicity)
# the kernels' launch geometry (csrc/bn254_fflonk.cu's #defines, read from
# the library on the card by geometry()): F2's block and run, F3's block
# and run in parts 1 and 2 (part 0 takes one point a thread)
INV_THREADS = 256
INV_RUN = 4
QUOTIENT_THREADS = 256
QUOTIENT_RUN = 64

_vp = ctypes.c_void_p


def _check(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.int64 or t.ndim != 2 or t.shape[1] != bf.N_LIMBS:
        raise TypeError(f"{name}: expected (m, 4) int64 limbs, got "
                        f"{t.dtype} {tuple(t.shape)}")


def scan_rows(length: int, k: int) -> int:
    return -(-length // k)


# ---------------------------------------------------------------------------
# F1: scans
# ---------------------------------------------------------------------------


def _op16(op: str, a, b):
    return bf.mul16(FR, a, b) if op == "mul" else bf.add16(FR, a, b)


def _identity16(op: str, device) -> torch.Tensor:
    return bf.const16(FR, 1, device) if op == "mul" else torch.zeros(
        bf.N16, dtype=torch.int64, device=device)


def scan_plain(x: torch.Tensor, k: int, op: str = "add",
               backward: bool = False) -> torch.Tensor:
    """The scan as log2(rows) batched steps over the rows of k (padded with
    the identity): y[u] = y[u - d] op y[u] for d = 1, 2, 4, ..."""
    length = x.shape[0]
    if length == 0:
        return x.clone()
    rows = scan_rows(length, k)
    y = _identity16(op, x.device).expand(rows * k, bf.N16).clone()
    y[:length] = bf.to16(x)
    y = y.reshape(rows, k, bf.N16)
    if backward:
        y = y.flip(0)
    d = 1
    while d < rows:
        y = torch.cat([y[:d], _op16(op, y[:-d], y[d:])])
        d *= 2
    if backward:
        y = y.flip(0)
    return bf.from16(y.reshape(rows * k, bf.N16)[:length])


def scan(x: torch.Tensor, k: int, op: str = "add", backward: bool = False,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inclusive scan of the chains i mod k of (m, 4) Montgomery `x` (canonical),
    by Fr addition or multiplication, forwards or backwards.  `out` may be
    `x` (in place) on the card."""
    _check(x, "scan")
    if op not in OPS or k < 1:
        raise ValueError(f"scan: op {op!r}, k {k}")
    if not x.is_cuda:
        res = scan_plain(x, k, op, backward)
        if out is not None:
            out.copy_(res)
            return out
        return res
    x = x.contiguous()
    length = x.shape[0]
    if out is None:
        out = torch.empty_like(x)
    if length == 0:
        return out
    lib = cuda_build.lib()
    seg = lib.merlin_bn_fr_scan_seg()
    rows = scan_rows(length, k)
    n_seg = -(-rows // seg)
    tot = torch.empty((n_seg * k, bf.N_LIMBS), dtype=torch.int64,
                      device=x.device) if n_seg > 1 else None
    stream = _vp(cuda_build.stream_ptr())
    shape = (length, k, op, bool(backward))
    cuda_build.check(lib.merlin_bn_fr_scan(
        _vp(x.data_ptr()), length, k, rows, OPS.index(op), int(backward),
        _vp(out.data_ptr()), _vp(tot.data_ptr() if tot is not None else None),
        stream), "bn254 fr scan")
    cuda_build.count(LAUNCHES, SHAPES, "scan", shape)
    if tot is not None:
        # the segments' totals are in scan order: scan them forwards
        carry = scan(tot, k, op, False, out=tot)
        cuda_build.check(lib.merlin_bn_fr_scan_carry(
            _vp(out.data_ptr()), length, k, rows, OPS.index(op),
            int(backward), _vp(carry.data_ptr()), stream),
            "bn254 fr scan carry")
        cuda_build.count(LAUNCHES, SHAPES, "scan_carry", shape)
    return out


# ---------------------------------------------------------------------------
# F2: inverses
# ---------------------------------------------------------------------------


def inv_plain(a: torch.Tensor) -> torch.Tensor:
    """a^(r - 2) by square-and-multiply over the exponent's bits."""
    x = bf.to16(a)
    r = bf.const16(FR, 1, a.device).expand(x.shape).clone()
    e = FR.mod - 2
    for bit in range(e.bit_length() - 1, -1, -1):
        r = bf.mul16(FR, r, r)
        if (e >> bit) & 1:
            r = bf.mul16(FR, r, x)
    return bf.from16(r)


def geometry() -> dict:
    """The launch geometry of F2 and F3 as the library was built:
    {"inv_threads", "inv_run", "quotient_threads", "quotient_run" (parts 1
    and 2; part 0 takes one point a thread)} (a thread's run of elements
    or points lies a block apart)."""
    lib = cuda_build.lib()
    return {k: lib.merlin_bn_fflonk_geometry(i) for i, k in enumerate(
        ("inv_threads", "inv_run", "quotient_threads", "quotient_run"))}


def inv(a: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse of (m, 4) Montgomery `a` (0 for 0)."""
    _check(a, "inv")
    if not a.is_cuda:
        return inv_plain(a)
    a = a.contiguous()
    out = torch.empty_like(a)
    n = a.shape[0]
    if n == 0:
        return out
    cuda_build.check(cuda_build.lib().merlin_bn_fr_inv(
        _vp(a.data_ptr()), n, _vp(out.data_ptr()),
        _vp(cuda_build.stream_ptr())), "bn254 fr inv")
    cuda_build.count(LAUNCHES, SHAPES, "inv", n)
    return out


# ---------------------------------------------------------------------------
# F3: quotient numerators
# ---------------------------------------------------------------------------


class _QuotientArgs(ctypes.Structure):
    """``struct QuotientArgs`` of ``csrc/bn254_fflonk.cu``, field for
    field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in QUOTIENT_COLUMNS]
                + [("out0", ctypes.c_void_p), ("out1", ctypes.c_void_p),
                   ("n", ctypes.c_longlong), ("shift", ctypes.c_longlong),
                   ("s_stride", ctypes.c_longlong),
                   ("sq", (ctypes.c_uint64 * 4) * TWO_ADICITY)]
                + [(name, ctypes.c_uint64 * 4) for name in
                   ("root_step", "beta", "gamma", "k1beta", "k2beta")])


def _mont_words(v: int):
    m = (int(v) % FR.mod) * FR.r % FR.mod
    return (ctypes.c_uint64 * 4)(*[(m >> (64 * j)) & ((1 << 64) - 1)
                                   for j in range(4)])


def _columns(part: int, cols: dict) -> Tuple[int, torch.device]:
    if part not in PART_COLUMNS:
        raise ValueError(f"quotient: part {part}")
    n, dev = None, None
    for name in PART_COLUMNS[part]:
        t = cols.get(name)
        if t is None:
            raise ValueError(f"quotient: part {part} needs column {name!r}")
        _check(t, "quotient")
        n = t.shape[0] if n is None else n
        dev = t.device if dev is None else dev
        if t.shape[0] != n or t.device != dev:
            raise ValueError("quotient: columns of different lengths or "
                             "devices")
    return n, dev


def _pow_rows16(root: int, rows: torch.Tensor) -> torch.Tensor:
    """root^rows, (m, 16) Montgomery limbs, by square-and-multiply over the
    rows' bits."""
    acc = bf.const16(FR, 1, rows.device).expand(rows.shape[0], bf.N16).clone()
    base = bf.const16(FR, root, rows.device)
    top = int(rows.max()) if rows.numel() else 0
    for bit in range(top.bit_length()):
        sel = ((rows >> bit) & 1).bool()
        acc = torch.where(sel[:, None], bf.mul16(FR, acc, base), acc)
        base = bf.mul16(FR, base, base)
    return acc


def power_runs_plain(root: int, n: int, threads: int = QUOTIENT_THREADS,
                     run: int = QUOTIENT_RUN, device=None) -> torch.Tensor:
    """root^i for i < n, (n, 16) Montgomery limbs, on F3's schedule: the
    thread j0 = b threads run + t (t < threads) takes the points j0 + r
    threads (r < run); its first power by square-and-multiply over j0's
    bits, then one product by root^threads a point."""
    per = threads * run
    starts = (torch.arange(-(-n // per), device=device)[:, None] * per
              + torch.arange(threads, device=device)[None]).reshape(-1)
    starts = starts[starts < n]
    x = _pow_rows16(root, starts)
    step = bf.const16(FR, pow(root, threads, FR.mod), device)
    out = torch.empty((n, bf.N16), dtype=torch.int64, device=device)
    for r in range(run):
        idx = starts + r * threads
        keep = idx < n
        if not bool(keep.any()):
            break
        out[idx[keep]] = x[keep]
        x = bf.mul16(FR, x, step)
    return out


def quotient_plain(part: int, cols: dict, root: int = 1, beta: int = 0,
                   gamma: int = 0, shift: int = 0,
                   rows: Optional[torch.Tensor] = None):
    """The numerators at the points `rows` of the domain (all of it when
    None: X on F3's schedule, power_runs_plain), in the plain arithmetic;
    the powers at `rows` by square-and-multiply over each row's bits."""
    n, dev = _columns(part, cols)

    def col(name, at=None):
        return bf.to16(cols[name] if at is None and rows is None else
                       cols[name][rows if at is None else at])

    mul = lambda x, y: bf.mul16(FR, x, y)      # noqa: E731
    add = lambda x, y: bf.add16(FR, x, y)      # noqa: E731
    a, b, c = col("a"), col("b"), col("c")
    if part == 0:
        t0 = add(add(add(add(add(mul(a, col("ql")), mul(b, col("qr"))),
                             mul(mul(a, b), col("qm"))), mul(c, col("qo"))),
                     col("qc")), col("pi"))
        return (bf.from16(t0),)
    x = power_runs_plain(root, n, device=dev) if rows is None else \
        _pow_rows16(root, rows)
    g = bf.const16(FR, gamma, dev)
    be = bf.const16(FR, beta, dev)
    bx = mul(x, be)
    num = mul(mul(add(add(a, bx), g),
                  add(add(b, mul(x, bf.const16(FR, K1 * beta, dev))), g)),
              add(add(c, mul(x, bf.const16(FR, K2 * beta, dev))), g))
    den = mul(mul(add(add(a, mul(col("s1"), be)), g),
                  add(add(b, mul(col("s2"), be)), g)),
              add(add(c, mul(col("s3"), be)), g))
    if part == 1:
        return bf.from16(num), bf.from16(den)
    z = col("z")
    t1 = mul(bf.sub16(FR, z, bf.const16(FR, 1, dev)), col("l1"))
    at = torch.arange(n, device=dev) if rows is None else rows
    zw = col("z", (at + shift) % n)
    t2 = bf.sub16(FR, mul(num, z), mul(den, zw))
    return bf.from16(t1), bf.from16(t2)


def _s_stride(cols: dict, part: int) -> int:
    """The row stride (in elements) that s1..s3 share as they are given
    (rows of 4 contiguous words a fixed number of elements apart); 0 when
    they share none (they are then copied)."""
    if part == 0:
        return 1
    strides = {cols[k].stride(0) if cols[k].stride(1) == 1 else -1
               for k in ("s1", "s2", "s3")}
    st = strides.pop()
    return st // bf.N_LIMBS if not strides and st > 0 and \
        st % bf.N_LIMBS == 0 else 0


def quotient(part: int, cols: dict, root: int = 1, beta: int = 0,
             gamma: int = 0, shift: int = 0):
    """Part 0: (t0,); part 1: (num, den); part 2: (t1, t2), each (n, 4)
    Montgomery over the n points of the columns' domain (X = root^i,
    z(omega X) = z[(i + shift) mod n]).  `cols` maps the names of
    QUOTIENT_COLUMNS that the part reads (PART_COLUMNS) to (n, 4)
    Montgomery columns (s1..s3 may be row-strided views, as ``x[::4]`` of
    a larger domain's evaluations, read in place); beta, gamma, root plain
    ints."""
    n, dev = _columns(part, cols)
    if dev.type != "cuda":
        return quotient_plain(part, cols, root, beta, gamma, shift)
    args = _QuotientArgs()
    keep = []
    s_stride = _s_stride(cols, part)
    for name in QUOTIENT_COLUMNS:
        t = cols.get(name) if name in PART_COLUMNS[part] else None
        if t is not None:
            if not (name in ("s1", "s2", "s3") and s_stride):
                t = t.contiguous()
            if t.data_ptr() % 16:
                raise ValueError(f"quotient: column {name!r} is not 16-byte "
                                 "aligned")
            keep.append(t)
        setattr(args, name, t.data_ptr() if t is not None else None)
    outs = tuple(torch.empty((n, bf.N_LIMBS), dtype=torch.int64, device=dev)
                 for _ in range(PART_OUTPUTS[part]))
    for j, name in enumerate(("out0", "out1")):
        setattr(args, name, outs[j].data_ptr() if j < len(outs) else None)
    args.n, args.s_stride = n, s_stride or 1
    args.shift = int(shift) % n if n else 0
    if n:
        geo = geometry()
        for i, v in enumerate(bn254_cuda.square_ints(root, n)):
            args.sq[i] = _mont_words(v)
        args.root_step = _mont_words(pow(root, geo["quotient_threads"],
                                         FR.mod))
        args.beta, args.gamma = _mont_words(beta), _mont_words(gamma)
        args.k1beta, args.k2beta = (_mont_words(K1 * beta),
                                    _mont_words(K2 * beta))
        cuda_build.check(cuda_build.lib().merlin_bn_fflonk_quotient(
            ctypes.byref(args), part, _vp(cuda_build.stream_ptr())),
            "bn254 fflonk quotient")
        cuda_build.count(LAUNCHES, SHAPES, "quotient", (part, n))
    del keep
    return outs
