"""alt_bn128 (BN254) curve arithmetic in Jacobian coordinates; kernel B4
(fixed-base scalar multiplication) and its plain twin.

Counterpart of the reference's ``snark/curve.py``.  A point is a
``Point(x, y, z)`` of field elements (z == 0 is infinity): (..., 4)
Montgomery tensors over Fq for G1 (``F1``), ``Fq2El(c0, c1)`` pairs of them
over Fq2 = Fq[u]/(u^2 + 1) for G2 (``F2``).  ``double`` and ``add`` follow
the reference's formulas, ``add`` complete by selects (infinity, equal and
opposite points).  They are the plain arithmetic (CPU, and small host-side
work on the card); each field product stage of a formula is one batched
product (``_mul_many``).

``scalar_mul_table`` (``[e_i] P`` for one base and many scalars, the
setup's point tables) launches B4 on a CUDA point
(``csrc/bn254_fixed_base.cu``):
one thread a scalar walks its signed ``w``-bit digits (``signed_digits``
is the recoding's twin) and adds, for each nonzero digit ``d`` of window
``j``, the affine point ``|d| 2^(w j) P`` (y negated for ``d < 0``) by a
mixed addition.  ``fixed_base_table`` builds those points on the host in
python ints, once per base (cached by the base's words: a Groth16 setup
multiplies two bases sixteen times).  ``scalar_mul_table_plain`` is the
twin and the specification: the reference's double-and-add scan read as
a sum, the doublings 2^k P of the base added pairwise over each scalar's
set bits.  Both sums are the same group element; they are compared in
affine form.  ``scalar_mul_words`` gives the table packed (the form a
large table such as fflonk's SRS keeps), and ``scalar_mul`` the table of
one scalar.  ``LAUNCHES`` counts B4's launches.
"""

from __future__ import annotations

import ctypes
import time
from collections import OrderedDict
from typing import List, NamedTuple, Optional

import torch

from ..ops import bn254_field as bf
from ..ops import cuda_build
from ..ops.bn254_field import FQ
from ..ops.goldilocks import resolve_device

LAUNCHES = {"fixed_base": 0}
SHAPES: dict = {}   # launches by shape: (group, scalars)
FB_WINDOW = 10      # B4's digit width (tools/bn254_times.py --windows)
FB_WINDOW_SMALL = 4  # ... below FB_SMALL_N scalars (a proof's blinding),
FB_SMALL_N = 4096    # where the table's host build costs more than the walk
FB_TABLES_KEPT = 8  # bases whose B4 tables stay cached
FB_TABLE_BUILDS = {"tables": 0, "host_s": 0.0}   # B4 tables built, seconds

_vp = ctypes.c_void_p


class Fq2El(NamedTuple):
    c0: torch.Tensor
    c1: torch.Tensor


class Point(NamedTuple):
    """Jacobian point; leaves are field elements (z == 0 -> infinity)."""

    x: object
    y: object
    z: object


# ---------------------------------------------------------------------------
# Base fields.  The carrier form ((..., 4) limbs; Fq2El pairs of them) and
# the 16-bit limb form of the plain arithmetic share these interfaces:
# `split` / `join` convert, the other methods take the 16-bit form.
# ---------------------------------------------------------------------------


class F1:
    """Base-field interface over Fq."""

    ctx = FQ
    words = 4      # carrier words of one element
    g2 = 0

    @staticmethod
    def split(a):
        return bf.to16(a)

    @staticmethod
    def join(a):
        return bf.from16(a)

    @staticmethod
    def mul_many(pairs):
        """[(a, b), ...] -> [a * b, ...], one batched product."""
        sh = torch.broadcast_shapes(*[t.shape for p in pairs for t in p])
        a = torch.stack([p[0].expand(sh) for p in pairs])
        b = torch.stack([p[1].expand(sh) for p in pairs])
        return list(bf.mul16(FQ, a, b).unbind(0))

    @staticmethod
    def add(a, b):
        return bf.add16(FQ, a, b)

    @staticmethod
    def sub(a, b):
        return bf.sub16(FQ, a, b)

    @staticmethod
    def neg(a):
        return bf.neg16(FQ, a)

    @staticmethod
    def is_zero(a):
        return bf.is_zero16(a)

    @staticmethod
    def select(p, a, b):
        return torch.where(p[..., None], a, b)

    @staticmethod
    def zeros(shape, device):
        return torch.zeros(tuple(shape) + (bf.N16,), dtype=torch.int64,
                           device=device)

    @staticmethod
    def one(shape, device):
        return bf.const16(FQ, 1, device).expand(tuple(shape) + (bf.N16,))

    @staticmethod
    def inv(a):
        return bf.to16(bf.inv(FQ, bf.from16(a)))

    @staticmethod
    def shape_of(a):
        return a.shape[:-1]

    @staticmethod
    def from_int(v, device=None):
        return bf.from_int(FQ, v, device)

    @staticmethod
    def flat(a):
        """carrier -> (..., 4) words"""
        return a

    @staticmethod
    def unflat(w):
        return w


class F2:
    """Quadratic extension Fq2 = Fq[u]/(u^2 + 1)."""

    ctx = FQ
    words = 8
    g2 = 1

    @staticmethod
    def split(a):
        return Fq2El(bf.to16(a.c0), bf.to16(a.c1))

    @staticmethod
    def join(a):
        return Fq2El(bf.from16(a.c0), bf.from16(a.c1))

    @staticmethod
    def mul_many(pairs):
        """Karatsuba, as the reference's F2.mul: three Fq products an
        element, all in one batched product."""
        ops = []
        for a, b in pairs:
            ops += [(a.c0, b.c0), (a.c1, b.c1),
                    (bf.add16(FQ, a.c0, a.c1), bf.add16(FQ, b.c0, b.c1))]
        prods = F1.mul_many(ops)
        out = []
        for k in range(len(pairs)):
            t0, t1, t2 = prods[3 * k:3 * k + 3]
            out.append(Fq2El(bf.sub16(FQ, t0, t1),
                             bf.sub16(FQ, bf.sub16(FQ, t2, t0), t1)))
        return out

    @staticmethod
    def add(a, b):
        return Fq2El(bf.add16(FQ, a.c0, b.c0), bf.add16(FQ, a.c1, b.c1))

    @staticmethod
    def sub(a, b):
        return Fq2El(bf.sub16(FQ, a.c0, b.c0), bf.sub16(FQ, a.c1, b.c1))

    @staticmethod
    def neg(a):
        return Fq2El(bf.neg16(FQ, a.c0), bf.neg16(FQ, a.c1))

    @staticmethod
    def is_zero(a):
        return bf.is_zero16(a.c0) & bf.is_zero16(a.c1)

    @staticmethod
    def select(p, a, b):
        return Fq2El(torch.where(p[..., None], a.c0, b.c0),
                     torch.where(p[..., None], a.c1, b.c1))

    @staticmethod
    def zeros(shape, device):
        return Fq2El(F1.zeros(shape, device), F1.zeros(shape, device))

    @staticmethod
    def one(shape, device):
        return Fq2El(F1.one(shape, device), F1.zeros(shape, device))

    @staticmethod
    def inv(a):
        # 1/(c0 + c1 u) = (c0 - c1 u) / (c0^2 + c1^2)
        s0, s1 = F1.mul_many([(a.c0, a.c0), (a.c1, a.c1)])
        ninv = F1.inv(bf.add16(FQ, s0, s1))
        c0, c1 = F1.mul_many([(a.c0, ninv), (bf.neg16(FQ, a.c1), ninv)])
        return Fq2El(c0, c1)

    @staticmethod
    def shape_of(a):
        return a.c0.shape[:-1]

    @staticmethod
    def from_int(pair, device=None):
        c0, c1 = pair
        return Fq2El(bf.from_int(FQ, c0, device), bf.from_int(FQ, c1, device))

    @staticmethod
    def flat(a):
        return torch.cat([a.c0, a.c1], dim=-1)

    @staticmethod
    def unflat(w):
        return Fq2El(w[..., :4], w[..., 4:])


def _map(F, fn, p: Point) -> Point:
    return Point(fn(p.x), fn(p.y), fn(p.z))


def split_point(F, p: Point) -> Point:
    return _map(F, F.split, p)


def join_point(F, p: Point) -> Point:
    return _map(F, F.join, p)


def _device_of(F, p: Point):
    return (p.x if F is F1 else p.x.c0).device


def pack(F, p: Point) -> torch.Tensor:
    """(..., 12) (G1) or (..., 24) (G2) words: x, y, z, the kernels' layout."""
    return torch.cat([F.flat(p.x), F.flat(p.y), F.flat(p.z)], dim=-1)


def unpack(F, w: torch.Tensor) -> Point:
    k = F.words
    return Point(F.unflat(w[..., :k]), F.unflat(w[..., k:2 * k]),
                 F.unflat(w[..., 2 * k:]))


# ---------------------------------------------------------------------------
# Plain point arithmetic on the 16-bit form
# ---------------------------------------------------------------------------


def _sel(F, pred, a: Point, b: Point) -> Point:
    return Point(F.select(pred, a.x, b.x), F.select(pred, a.y, b.y),
                 F.select(pred, a.z, b.z))


def _inf16(F, shape, device) -> Point:
    return Point(F.one(shape, device), F.one(shape, device),
                 F.zeros(shape, device))


def _bcast(F, p: Point, shape) -> Point:
    def b(leaf):
        if F is F2:
            return Fq2El(leaf.c0.expand(tuple(shape) + (bf.N16,)),
                         leaf.c1.expand(tuple(shape) + (bf.N16,)))
        return leaf.expand(tuple(shape) + (bf.N16,))
    return Point(b(p.x), b(p.y), b(p.z))


def _shape(F, p: Point):
    return torch.broadcast_shapes(F.shape_of(p.x), F.shape_of(p.z))


def double16(F, p: Point) -> Point:
    a, b, yz = F.mul_many([(p.x, p.x), (p.y, p.y), (p.y, p.z)])
    xb = F.add(p.x, b)
    c, t = F.mul_many([(b, b), (xb, xb)])
    tac = F.sub(F.sub(t, a), c)
    d = F.add(tac, tac)
    e = F.add(F.add(a, a), a)
    (f,) = F.mul_many([(e, e)])
    x3 = F.sub(f, F.add(d, d))
    c2 = F.add(c, c)
    c4 = F.add(c2, c2)
    c8 = F.add(c4, c4)
    (ey,) = F.mul_many([(e, F.sub(d, x3))])
    y3 = F.sub(ey, c8)
    z3 = F.add(yz, yz)
    inf = F.is_zero(p.z)
    return _sel(F, inf, p, Point(x3, y3, z3))


def add16(F, p: Point, q: Point) -> Point:
    """Complete addition (the reference's selects)."""
    shape = torch.broadcast_shapes(_shape(F, p), _shape(F, q))
    z1z1, z2z2, z1z2 = F.mul_many([(p.z, p.z), (q.z, q.z), (p.z, q.z)])
    u1, u2, s1a, s2a = F.mul_many([(p.x, z2z2), (q.x, z1z1), (p.y, q.z),
                                   (q.y, p.z)])
    s1, s2 = F.mul_many([(s1a, z2z2), (s2a, z1z1)])
    h = F.sub(u2, u1)
    r = F.sub(s2, s1)
    hh, rr = F.mul_many([(h, h), (r, r)])
    hhh, v, z3 = F.mul_many([(h, hh), (u1, hh), (z1z2, h)])
    x3 = F.sub(F.sub(rr, hhh), F.add(v, v))
    ry, shh = F.mul_many([(r, F.sub(v, x3)), (s1, hhh)])
    res = Point(x3, F.sub(ry, shh), z3)
    same_x = F.is_zero(h)
    same_y = F.is_zero(r)
    both = same_x & same_y
    if bool(both.any()):                 # equal points: the doubling
        res = _sel(F, both, double16(F, _bcast(F, p, shape)), res)
    dev = _device_of(F, res)
    res = _sel(F, same_x & ~same_y, _inf16(F, shape, dev), res)
    res = _sel(F, F.is_zero(p.z), _bcast(F, q, shape), res)
    res = _sel(F, F.is_zero(q.z), _bcast(F, p, shape), res)
    return res


def neg16(F, p: Point) -> Point:
    return Point(p.x, F.neg(p.y), p.z)


# ---------------------------------------------------------------------------
# The public carrier-form API
# ---------------------------------------------------------------------------


def infinity(F, shape=(), device=None) -> Point:
    device = resolve_device(device)
    return join_point(F, _inf16(F, shape, device))


def from_affine(F, x, y) -> Point:
    shape = F.shape_of(x)
    dev = (x if F is F1 else x.c0).device
    return Point(x, y, F.join(F.one(shape, dev)))


def is_infinity(F, p: Point):
    z = F.split(p.z)
    return F.is_zero(z)


def double(F, p: Point) -> Point:
    return join_point(F, double16(F, split_point(F, p)))


def add(F, p: Point, q: Point) -> Point:
    return join_point(F, add16(F, split_point(F, p), split_point(F, q)))


def neg(F, p: Point) -> Point:
    return join_point(F, neg16(F, split_point(F, p)))


def to_affine(F, p: Point):
    """Returns (x, y, is_inf); (x, y) = (X / Z^2, Y / Z^3), an infinity's
    (x, y) are its X, Y as the reference's."""
    q = split_point(F, p)
    inf = F.is_zero(q.z)
    shape = F.shape_of(q.z)
    dev = _device_of(F, q)
    zinv = F.inv(F.select(inf, F.one(shape, dev), q.z))
    (zinv2,) = F.mul_many([(zinv, zinv)])
    x, zinv3 = F.mul_many([(q.x, zinv2), (zinv2, zinv)])
    (y,) = F.mul_many([(q.y, zinv3)])
    return F.join(x), F.join(y), inf


def affine_ints(F, p) -> List:
    """Every point of `p` as python ints: None for infinity, (x, y) over
    Fq, ((x0, x1), (y0, y1)) over Fq2; the form in which two projective
    forms of one point compare equal.  `p` a Point, or (n, 2 W) affine
    words (x then y, Montgomery; an x of all ones for infinity: the form
    of B3's bases, ``msm.affine_bases``)."""
    if isinstance(p, torch.Tensor):
        k = F.words
        inf = (p[:, 3] == -1).tolist()
        x = F.unflat(p[:, :k])
        y = F.unflat(p[:, k:])
    else:
        x, y, inf = to_affine(F, p)
        inf = inf.reshape(-1).tolist()
    if F is F1:
        xs = bf.to_int(FQ, x).reshape(-1)
        ys = bf.to_int(FQ, y).reshape(-1)
        return [None if i else (int(a), int(b))
                for i, a, b in zip(inf, xs, ys)]
    x0, x1 = (bf.to_int(FQ, c).reshape(-1) for c in x)
    y0, y1 = (bf.to_int(FQ, c).reshape(-1) for c in y)
    return [None if i else ((int(a0), int(a1)), (int(b0), int(b1)))
            for i, a0, a1, b0, b1 in zip(inf, x0, x1, y0, y1)]


def affine_words_from_ints(F, pts, device=None) -> torch.Tensor:
    """(n, 2 W) affine words of python-int points (None for infinity), as
    ``affine_ints`` gives them."""
    device = resolve_device(device)
    rows = []
    for p in pts:
        if p is None:
            rows.append([(1 << 256) - 1] * (F.words // 4) + [0] * (F.words // 4))
        elif F is F1:
            rows.append([c * FQ.r % _Q for c in p])
        else:
            rows.append([c * FQ.r % _Q for xy in p for c in xy])
    flat = [v for r in rows for v in r]
    return bf.from_u64(bf.ints_to_limbs(flat), device).reshape(
        len(rows), 2 * F.words)


def scalar_bits(scalars: torch.Tensor) -> torch.Tensor:
    """(n, 4) plain scalar limbs -> (n, 256) bool, bit k of limb k // 64."""
    k = torch.arange(64, device=scalars.device)
    return ((scalars[:, :, None] >> k) & 1).reshape(-1, 256).bool()


def _scalar_limbs(scalars, device) -> torch.Tensor:
    if isinstance(scalars, torch.Tensor):
        return scalars.to(device)
    return bf.scalars_to_limbs([int(e) % (1 << 256) for e in scalars], device)


_CHAINS: dict = {}


def _doublings16(F, p: Point, top: int) -> Point:
    """2^k P for k < top as one point array (leaves (top, 16)), the 16-bit
    form; cached by the point's words (the setup and the blinding double
    the same few bases again and again)."""
    words = pack(F, p).reshape(-1)
    key = (F.g2, str(words.device), tuple(words.tolist()))
    have = _CHAINS.get(key)
    if have is None or have[0] < top:
        base = split_point(F, p)
        rows = []
        for _ in range(top):
            rows.append(base)
            base = double16(F, base)
        have = (top, _stack_points(F, rows))
        _CHAINS[key] = have
    return _map(F, lambda a: _take_rows(F, a, top), have[1])


def _stack_points(F, rows) -> Point:
    if F is F2:
        return Point(*[Fq2El(torch.stack([getattr(r, f).c0 for r in rows]),
                             torch.stack([getattr(r, f).c1 for r in rows]))
                       for f in ("x", "y", "z")])
    return Point(*[torch.stack([getattr(r, f) for r in rows])
                   for f in ("x", "y", "z")])


def _take_rows(F, a, k):
    return Fq2El(a.c0[:k], a.c1[:k]) if F is F2 else a[:k]


def scalar_mul_table_plain(F, p: Point, scalars: torch.Tensor) -> Point:
    """Twin of B4: the doublings 2^k P of the base, then for each scalar
    the sum of those of its set bits, summed pairwise as B3's twin sums a
    bucket (``msm.run_sums_plain``)."""
    from .msm import run_sums_plain

    dev = _device_of(F, p)
    n = scalars.shape[0]
    bits = scalar_bits(scalars)
    top = int(bits.any(dim=0).nonzero().max()) + 1 if bool(bits.any()) else 0
    out = pack(F, infinity(F, (n,), dev))
    if top:
        table = pack(F, join_point(F, _doublings16(F, p, top)))
        ent = torch.nonzero(bits[:, :top])        # by scalar, then bit
        sums, keys = run_sums_plain(F, table[ent[:, 1]], ent[:, 0])
        out[keys] = sums
    return unpack(F, out)


def scalar_mul_table(F, p: Point, scalars) -> Point:
    """[e * p for e in scalars] as one (n,) Point; scalars python ints or
    (n, 4) plain limbs.  On the card through kernel B4."""
    dev = _device_of(F, p)
    s = _scalar_limbs(scalars, dev)
    if not s.is_cuda:
        return scalar_mul_table_plain(F, p, s)
    return unpack(F, scalar_mul_words(F, p, s))


def scalar_mul_words(F, p: Point, scalars, w: Optional[int] = None
                     ) -> torch.Tensor:
    """scalar_mul_table as (n, 12) or (n, 24) packed words (``pack``), the
    form a large table keeps (the MSM reads it without a copy); ``w`` the
    digit width of B4's walk (default ``fixed_base_width(n)``)."""
    dev = _device_of(F, p)
    s = _scalar_limbs(scalars, dev)
    if not s.is_cuda:
        return pack(F, scalar_mul_table_plain(F, p, s))
    n = s.shape[0]
    w = w or fixed_base_width(n)
    s = s.contiguous()
    table = fixed_base_table(F, p, w)
    out = torch.empty((n, 3 * F.words), dtype=torch.int64, device=dev)
    if n:
        cuda_build.check(cuda_build.lib().merlin_bn_fixed_base(
            F.g2, _vp(table.data_ptr()), _vp(s.data_ptr()), n, w,
            _vp(out.data_ptr()), _vp(cuda_build.stream_ptr())),
            "bn254 fixed base")
        cuda_build.count(LAUNCHES, SHAPES, "fixed_base",
                         ("G2" if F is F2 else "G1", n))
    return out


# ---------------------------------------------------------------------------
# B4's signed digits and affine tables (python ints on the host)
# ---------------------------------------------------------------------------


def fixed_base_width(n: int) -> int:
    """B4's digit width for n scalars: FB_WINDOW for a large table (fewer
    additions a scalar), FB_WINDOW_SMALL for a few (a table of 2^(w-1)
    points a window is built on the host for each new base)."""
    return FB_WINDOW if n >= FB_SMALL_N else FB_WINDOW_SMALL


def fixed_base_windows(w: int) -> int:
    """Windows of B4's walk: 256 // w + 1 (the last takes the carry out of
    a 256-bit scalar; its digit is at most 2^(256 mod w) <= 2^(w - 1))."""
    return 256 // w + 1


def signed_digits(e: int, w: int) -> List[int]:
    """Twin of B4's recoding of a scalar e < 2^256, low window first:
    v = (bits j of e) + carry; digit v - 2^w and carry 1 where v > 2^(w-1),
    else digit v and carry 0.  sum_j d_j 2^(w j) = e, |d_j| <= 2^(w-1)."""
    half, mask = 1 << (w - 1), (1 << w) - 1
    out, carry = [], 0
    for j in range(fixed_base_windows(w)):
        v = ((e >> (w * j)) & mask) + carry
        carry = int(v > half)
        out.append(v - (carry << w))
    return out


_Q = FQ.mod


def _fmul(g2, a, b):
    if not g2:
        return a * b % _Q
    t0, t1 = a[0] * b[0], a[1] * b[1]
    return ((t0 - t1) % _Q, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % _Q)


def _fsub(g2, a, b):
    return (a - b) % _Q if not g2 else ((a[0] - b[0]) % _Q, (a[1] - b[1]) % _Q)


def _fscale(g2, a, k):
    return a * k % _Q if not g2 else (a[0] * k % _Q, a[1] * k % _Q)


def _batch_inv(g2, xs):
    """Inverses of nonzero Fq or Fq2 elements with one modular inversion
    (Montgomery's trick over the norms)."""
    norms = xs if not g2 else [(a * a + b * b) % _Q for a, b in xs]
    pre, acc = [], 1
    for v in norms:
        pre.append(acc)
        acc = acc * v % _Q
    inv = pow(acc, -1, _Q)
    out = [0] * len(norms)
    for k in range(len(norms) - 1, -1, -1):
        out[k] = inv * pre[k] % _Q
        inv = inv * norms[k] % _Q
    if not g2:
        return out
    return [(a * n % _Q, -b * n % _Q) for (a, b), n in zip(xs, out)]


def _affine_add_many(g2, ps, qs):
    """ps[i] + qs[i] for affine points (None is infinity), complete, with
    one inversion for the lot."""
    zero = 0 if not g2 else (0, 0)
    out = list(ps)
    todo, nums, dens = [], [], []
    for i, (p, q) in enumerate(zip(ps, qs)):
        if p is None or q is None:
            out[i] = q if p is None else p
        elif p[0] == q[0]:
            if _fsub(g2, zero, p[1]) == q[1]:
                out[i] = None
            else:                            # p == q: the tangent
                todo.append(i)
                nums.append(_fscale(g2, _fmul(g2, p[0], p[0]), 3))
                dens.append(_fscale(g2, p[1], 2))
        else:
            todo.append(i)
            nums.append(_fsub(g2, q[1], p[1]))
            dens.append(_fsub(g2, q[0], p[0]))
    for i, num, inv in zip(todo, nums, _batch_inv(g2, dens)):
        (x1, y1), (x2, _) = ps[i], qs[i]
        lam = _fmul(g2, num, inv)
        x3 = _fsub(g2, _fsub(g2, _fmul(g2, lam, lam), x1), x2)
        out[i] = (x3, _fsub(g2, _fmul(g2, lam, _fsub(g2, x1, x3)), y1))
    return out


def fixed_base_table_ints(g2: bool, base, w: int) -> List:
    """B4's table as python ints: entry j * 2^(w-1) + d - 1 is the affine
    point d 2^(w j) P (None for infinity) for d = 1 .. 2^(w-1) and every
    window j; `base` affine ((x, y), Fq2 pairs for G2) or None."""
    half, n_win = 1 << (w - 1), fixed_base_windows(w)
    bases = [base]
    for _ in range(n_win - 1):
        b = bases[-1]
        for _ in range(w):
            (b,) = _affine_add_many(g2, [b], [b])
        bases.append(b)
    rows = [bases]
    for _ in range(half - 1):
        rows.append(_affine_add_many(g2, rows[-1], bases))
    return [rows[d][j] for j in range(n_win) for d in range(half)]


def _base_affine(F, p: Point):
    """The one base point of `p` as python-int affine coordinates (None for
    infinity), from its Montgomery words on the host."""
    ints = bf.limbs_to_ints(pack(F, p).reshape(-1, 4))
    rinv = pow(FQ.r, -1, _Q)
    v = [a * rinv % _Q for a in ints]
    g2 = bool(F.g2)
    x, y, z = ((v[0], v[1], v[2]) if not g2
               else ((v[0], v[1]), (v[2], v[3]), (v[4], v[5])))
    if z == (0 if not g2 else (0, 0)):
        return None
    (zi,) = _batch_inv(g2, [z])
    zi2 = _fmul(g2, zi, zi)
    return _fmul(g2, x, zi2), _fmul(g2, y, _fmul(g2, zi2, zi))


_FB_TABLES: "OrderedDict" = OrderedDict()


def fixed_base_table(F, p: Point, w: int) -> torch.Tensor:
    """B4's table for the base `p` on its device: (windows * 2^(w-1),
    2 * words) int64, each entry x then y in Montgomery form, an x of all
    ones and a y of zeros for infinity; cached by the base's words (the
    last FB_TABLES_KEPT bases)."""
    words = pack(F, p).reshape(-1)
    if words.numel() != 3 * F.words:
        raise ValueError("scalar_mul_table: one base point expected")
    dev = words.device
    key = (F.g2, w, str(dev), tuple(words.tolist()))
    table = _FB_TABLES.get(key)
    if table is None:
        t0 = time.perf_counter()
        pts = fixed_base_table_ints(bool(F.g2), _base_affine(F, p), w)
        ones, zero = (1 << 256) - 1, [0] * (F.words // 4)
        flat = []
        for pt in pts:
            if pt is None:                  # x all ones: no element has it
                flat += [ones] * (F.words // 4) + zero
            else:
                flat += [c * FQ.r % _Q for c in
                         ([c for xy in pt for c in xy] if F.g2 else pt)]
        table = bf.from_u64(bf.ints_to_limbs(flat), dev).reshape(
            len(pts), 2 * F.words)
        _FB_TABLES[key] = table
        FB_TABLE_BUILDS["tables"] += 1
        FB_TABLE_BUILDS["host_s"] += time.perf_counter() - t0
        while len(_FB_TABLES) > FB_TABLES_KEPT:
            _FB_TABLES.popitem(last=False)
    else:
        _FB_TABLES.move_to_end(key)
    return table


def scalar_mul(F, p: Point, e: int) -> Point:
    """p * e (one point)."""
    q = scalar_mul_table(F, p, [int(e) % (1 << 256)])
    return Point(*[_index0(F, leaf) for leaf in q])


def _unsqueeze1(F, leaf):
    return Fq2El(leaf.c0[None], leaf.c1[None]) if F is F2 else leaf[None]


def _index0(F, leaf):
    return Fq2El(leaf.c0[0], leaf.c1[0]) if F is F2 else leaf[0]


# Generators
G1_GEN = (1, 2)
G2_GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)


def g1_generator(device=None) -> Point:
    device = resolve_device(device)
    return from_affine(F1, F1.from_int(G1_GEN[0], device),
                       F1.from_int(G1_GEN[1], device))


def g2_generator(device=None) -> Point:
    device = resolve_device(device)
    return from_affine(
        F2,
        F2.from_int((G2_GEN[0][0], G2_GEN[0][1]), device),
        F2.from_int((G2_GEN[1][0], G2_GEN[1][1]), device),
    )
