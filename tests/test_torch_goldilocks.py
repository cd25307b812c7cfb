"""The port's Goldilocks field and cubic extension against the python-int
oracle and the JAX functions.  All comparisons are exact (tolerance zero):
field arithmetic has no rounding."""

import numpy as np
import pytest
import torch

# the suite runs several workers side by side: one thread each
torch.set_num_threads(1)

import field_oracle as fo
from merlin_zkevm_prover_tpu.ops import goldilocks as jgl
from merlin_zkevm_prover_tpu.ops import goldilocks3 as jgl3
from merlin_zkevm_prover_tpu_torch import convert
from merlin_zkevm_prover_tpu_torch.ops import goldilocks as gl
from merlin_zkevm_prover_tpu_torch.ops import goldilocks3 as gl3

P = gl.P
CPU = "cpu"
EDGE = [0, 1, 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1, P - (1 << 32), P - 2,
        P - 1, 1 << 63, (1 << 63) - 1, (1 << 63) + 1]


def _pairs():
    rng = np.random.default_rng(11)
    vals = EDGE + [int(v) for v in rng.integers(0, P, 20, dtype=np.uint64)]
    a = np.array([x for x in vals for _ in vals], dtype=np.uint64)
    b = np.array([y for _ in vals for y in vals], dtype=np.uint64)
    return a, b


A, B = _pairs()


def _ints(x):
    return [int(v) for v in x]


def test_constants_match_reference():
    assert (gl.P, gl.EPSILON, gl.SHIFT, gl.SHIFT_INV) == \
        (jgl.P, jgl.EPSILON, jgl.SHIFT, jgl.SHIFT_INV)
    assert [gl.w(k) for k in range(33)] == [jgl.w(k) for k in range(33)]
    assert gl.w_inv(7) == jgl.w_inv(7)
    assert np.array_equal(gl.powers_np(7, 9, 3), jgl.powers_np(7, 9, 3))
    assert np.array_equal(gl.to_u64(gl.powers(7, 9, 3, CPU)),
                          jgl.powers_np(7, 9, 3))


def test_u64_roundtrip_and_limbs():
    t = gl.from_u64(A, CPU)
    assert np.array_equal(gl.to_u64(t), A)
    lo, hi = convert.gl_to_limbs(t)
    j = jgl.from_u64(A)
    assert np.array_equal(lo, np.asarray(j.lo))
    assert np.array_equal(hi, np.asarray(j.hi))
    assert np.array_equal(gl.to_u64(convert.gl_from_limbs(lo, hi, CPU)), A)


@pytest.mark.parametrize("name,oracle", [
    ("add", lambda x, y: (x + y) % P),
    ("sub", lambda x, y: (x - y) % P),
    ("mul", lambda x, y: (x * y) % P),
])
def test_binary_ops_edge_pairs(name, oracle):
    a, b = gl.from_u64(A, CPU), gl.from_u64(B, CPU)
    got = gl.to_u64(getattr(gl, name)(a, b))
    want = np.array([oracle(x, y) for x, y in zip(_ints(A), _ints(B))],
                    dtype=np.uint64)
    assert np.array_equal(got, want)
    ref = jgl.to_u64(getattr(jgl, name)(jgl.from_u64(A), jgl.from_u64(B)))
    assert np.array_equal(got, ref)


def test_int_operands_and_unary_ops():
    a = gl.from_u64(A, CPU)
    ai = _ints(A)
    u = np.uint64
    assert np.array_equal(gl.to_u64(gl.add(a, P - 1)),
                          np.array([(x - 1) % P for x in ai], dtype=u))
    assert np.array_equal(gl.to_u64(gl.sub(a, 5)),
                          np.array([(x - 5) % P for x in ai], dtype=u))
    assert np.array_equal(gl.to_u64(gl.mul(a, P - 2)),
                          np.array([x * (P - 2) % P for x in ai], dtype=u))
    assert np.array_equal(gl.to_u64(gl.neg(a)),
                          np.array([(-x) % P for x in ai], dtype=u))
    assert np.array_equal(gl.to_u64(gl.sqr(a)),
                          np.array([x * x % P for x in ai], dtype=u))
    assert np.array_equal(gl.to_u64(gl.pow7(a)),
                          np.array([pow(x, 7, P) for x in ai], dtype=u))
    for c in (0, 1, 41, (1 << 32) - 1):
        assert np.array_equal(gl.to_u64(gl.mul_small(a, c)),
                              np.array([x * c % P for x in ai], dtype=u))
    assert np.array_equal(gl.to_u64(gl.exp(a, 12345)),
                          np.array([pow(x, 12345, P) for x in ai], dtype=u))
    assert np.array_equal(gl.to_u64(gl.inv(a)),
                          np.array([pow(x, P - 2, P) for x in ai], dtype=u))
    assert np.array_equal(gl.is_zero(a).numpy(), A == 0)
    b = gl.from_u64(B, CPU)
    assert np.array_equal(gl.eq(a, b).numpy(), A == B)
    assert np.array_equal(gl.ult(a, b).numpy(), A < B)
    assert np.array_equal(gl.to_u64(gl.select(gl.eq(a, b), a, gl.neg(b))),
                          np.where(A == B, A, gl.to_u64(gl.neg(b))))
    assert np.array_equal(gl.to_u64(gl.canon(gl.from_u64(
        np.array([P, P + 5, 2**64 - 1, P - 1, 0], dtype=u), CPU))),
        np.array([0, 5, 2**32 - 2, P - 1, 0], dtype=u))


def test_bulk_helpers_match_reference():
    rng = np.random.default_rng(3)
    x = rng.integers(0, P, (13, 3), dtype=np.uint64)
    x[4, 1] = 0
    t, j = gl.from_u64(x, CPU), jgl.from_u64(x)
    assert np.array_equal(gl.to_u64(gl.sum_axis0(t)), jgl.to_u64(jgl.sum_axis0(j)))
    assert np.array_equal(gl.to_u64(gl.batch_inverse(t, axis=0)),
                          jgl.to_u64(jgl.batch_inverse(j, axis=0)))
    assert np.array_equal(gl.to_u64(gl.batch_inverse(t, axis=-1)),
                          np.array([[pow(int(v), P - 2, P) for v in r] for r in x],
                                   dtype=np.uint64))
    assert gl.to_u64(gl.concat([t, t], axis=1)).shape == (13, 6)
    assert gl.to_u64(gl.stack([t, t], axis=0)).shape == (2, 13, 3)


def test_gl3_ops_match_oracle_and_reference():
    rng = np.random.default_rng(5)
    a = rng.integers(0, P, (40, 3), dtype=np.uint64)
    b = rng.integers(0, P, (40, 3), dtype=np.uint64)
    a[:len(EDGE), 0] = EDGE
    b[:len(EDGE), 2] = EDGE[::-1]
    ta, tb = gl3.from_u64(a, CPU), gl3.from_u64(b, CPU)
    ja, jb = jgl3.from_u64(a), jgl3.from_u64(b)
    assert np.array_equal(gl3.to_u64(ta), a)
    prod = gl3.to_u64(gl3.mul(ta, tb))
    want = np.array([fo.gl3_mul(tuple(_ints(x)), tuple(_ints(y)))
                     for x, y in zip(a, b)], dtype=np.uint64)
    assert np.array_equal(prod, want)
    assert np.array_equal(prod, jgl3.to_u64(jgl3.mul(ja, jb)))
    for name in ("add", "sub"):
        assert np.array_equal(gl3.to_u64(getattr(gl3, name)(ta, tb)),
                              jgl3.to_u64(getattr(jgl3, name)(ja, jb)))
    assert np.array_equal(gl3.to_u64(gl3.neg(ta)), jgl3.to_u64(jgl3.neg(ja)))
    assert np.array_equal(gl3.to_u64(gl3.mul_base(ta, tb.c1)),
                          jgl3.to_u64(jgl3.mul_base(ja, jb.c1)))
    inv = gl3.to_u64(gl3.inv(ta))
    assert np.array_equal(inv, jgl3.to_u64(jgl3.inv(ja)))
    assert tuple(_ints(inv[20])) == fo.gl3_inv(tuple(_ints(a[20])))
    assert np.array_equal(gl3.to_u64(gl3.exp(ta, 11)),
                          jgl3.to_u64(jgl3.exp(ja, 11)))
    assert np.array_equal(gl3.to_u64(gl3.frobenius(ta)),
                          jgl3.to_u64(jgl3.frobenius(ja)))
    limbs = convert.gl3_to_limbs(ta)
    assert np.array_equal(limbs[1][0], np.asarray(ja.c1.lo))
    assert np.array_equal(gl3.to_u64(convert.gl3_from_limbs(limbs, CPU)), a)


def test_gl3_scans_match_reference():
    """Same values as the reference's blocked lax.scan form, not the same
    blocking."""
    rng = np.random.default_rng(6)
    a = rng.integers(0, P, (37, 3), dtype=np.uint64)
    t, j = gl3.from_u64(a, CPU), jgl3.from_u64(a)
    for reverse in (False, True):
        for inclusive in (False, True):
            assert np.array_equal(
                gl3.to_u64(gl3.prefix_prod(t, reverse, inclusive)),
                jgl3.to_u64(jgl3.prefix_prod(j, reverse, inclusive)))
    assert np.array_equal(gl3.to_u64(gl3.powers_scan(t[3], 37)),
                          jgl3.to_u64(jgl3.powers_scan(j[3], 37)))
    assert np.array_equal(gl3.to_u64(gl3.batch_inverse_parallel(t)),
                          jgl3.to_u64(jgl3.batch_inverse_parallel(j)))
    a[5] = 0
    t, j = gl3.from_u64(a, CPU), jgl3.from_u64(a)
    assert np.array_equal(gl3.to_u64(gl3.batch_inverse(t)),
                          jgl3.to_u64(jgl3.batch_inverse(j)))
    assert np.array_equal(gl3.to_u64(gl3.sum_axis0(t)),
                          jgl3.to_u64(jgl3.sum_axis0(j)))


def test_default_device_is_the_gpu_or_an_error():
    if torch.cuda.is_available():
        assert gl.zeros((2,)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            gl.zeros((2,))
        with pytest.raises(RuntimeError):
            gl.from_u64([1, 2])
