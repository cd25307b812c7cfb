"""The port's NTT / LDE on the CPU against the JAX plain path, the Pallas
kernels in interpret mode, a python-int DFT and closed-form probes.  All
comparisons are exact (tolerance zero).

On the CPU the port's public functions run the same DIF -> gather -> DIT
pipeline and four-step recursion as on the GPU, with each block kernel
replaced by its plain version; the ``*_plain`` functions are a separate
whole-length radix-2 transform."""

import numpy as np
import pytest
import torch

# the suite runs several workers side by side: one thread each
torch.set_num_threads(1)

from merlin_zkevm_prover_tpu.ops import goldilocks as jgl
from merlin_zkevm_prover_tpu.ops import ntt as jntt
from merlin_zkevm_prover_tpu_torch.ops import goldilocks as gl
from merlin_zkevm_prover_tpu_torch.ops import ntt, ntt_cuda

P, SHIFT = gl.P, gl.SHIFT
CPU = "cpu"


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint64)


def _naive(col, inverse=False):
    n = len(col)
    nb = n.bit_length() - 1
    w = gl.w_inv(nb) if inverse else gl.w(nb)
    out = [sum(int(col[i]) * pow(w, i * k, P) for i in range(n)) % P
           for k in range(n)]
    if inverse:
        ninv = pow(n, P - 2, P)
        out = [o * ninv % P for o in out]
    return np.array(out, dtype=np.uint64)


@pytest.mark.parametrize("nbits", [1, 2, 3, 4, 5])
def test_ntt_intt_match_python_dft(nbits):
    a = _rand((1 << nbits,), nbits)
    t = gl.from_u64(a, CPU)
    assert np.array_equal(gl.to_u64(ntt.ntt(t)), _naive(a))
    assert np.array_equal(gl.to_u64(ntt.intt(t)), _naive(a, True))
    assert np.array_equal(gl.to_u64(ntt.ntt_plain(t)), _naive(a))
    assert np.array_equal(gl.to_u64(ntt.intt(ntt.ntt(t))), a)


@pytest.mark.parametrize("nbits", list(range(1, 11)))
@pytest.mark.parametrize("shape", ["1d", "2d", "3d"])
def test_kernel_route_equals_plain_radix2(nbits, shape):
    """ntt / intt / extend_pol (pipeline or recursion over the block
    transform) against the whole-length radix-2 form, at every size 1..10
    and on 1-D, 2-D and 3-D inputs."""
    tail = {"1d": (), "2d": (3,), "3d": (2, 3)}[shape]
    t = gl.from_u64(_rand((1 << nbits,) + tail, 100 + nbits), CPU)
    assert np.array_equal(gl.to_u64(ntt.ntt(t)), gl.to_u64(ntt.ntt_plain(t)))
    assert np.array_equal(gl.to_u64(ntt.intt(t)), gl.to_u64(ntt.intt_plain(t)))
    for blow in (1, 2):
        got = ntt.extend_pol(t, nbits, nbits + blow)
        assert tuple(got.shape) == ((1 << (nbits + blow),) + tail)
        assert np.array_equal(
            gl.to_u64(got),
            gl.to_u64(ntt.extend_pol_plain(t, nbits, nbits + blow)))


@pytest.mark.parametrize("nbits,shape", [(1, (2,)), (4, (3,)), (10, (2,)),
                                         (5, ()), (2, (8, 3))])
def test_matches_reference_plain_path(nbits, shape):
    a = _rand((1 << nbits,) + shape, 200 + nbits)
    t, j = gl.from_u64(a, CPU), jgl.from_u64(a)
    assert np.array_equal(gl.to_u64(ntt.ntt(t)), jgl.to_u64(jntt.ntt(j)))
    assert np.array_equal(gl.to_u64(ntt.intt(t)), jgl.to_u64(jntt.intt(j)))
    assert np.array_equal(
        gl.to_u64(ntt.extend_pol(t, nbits, nbits + 1)),
        jgl.to_u64(jntt.extend_pol(j, nbits, nbits + 1)))


def test_extend_pol_blocked_and_coset_scale_match_reference():
    a = _rand((16, 70), 7)
    t, j = gl.from_u64(a, CPU), jgl.from_u64(a)
    got = gl.to_u64(ntt.extend_pol_blocked(t, 4, 5))
    assert np.array_equal(got, jgl.to_u64(jntt.extend_pol_blocked(j, 4, 5)))
    assert np.array_equal(got, gl.to_u64(ntt.extend_pol_plain(t, 4, 5)))
    assert np.array_equal(gl.to_u64(ntt.coset_scale(t)),
                          jgl.to_u64(jntt.coset_scale(j)))
    x = jgl.const(12345)
    assert np.array_equal(
        gl.to_u64(ntt.eval_pol_coeffs(t, gl.const(12345, device=CPU))),
        jgl.to_u64(jntt.eval_pol_coeffs(j, x)))


@pytest.mark.parametrize("nbits,cols", [(4, 3)])
def test_matches_pallas_kernels_interpret(nbits, cols):
    """The (4, 3) shape of the reference's own interpret-mode test, which
    goes through the short DIT kernel.  Its second shape, (10, 1), runs the
    DIF -> gather -> DIT pipeline at block length 512, which the Pallas
    interpreter does not finish in 20 minutes on a CPU.  That kernel's body
    is held at block length 16 instead, with each flag combination
    (test_block_matches_pallas_v3_kernel_interpret), and the pipeline around
    it against the reference's plain path and its host tables
    (test_matches_reference_plain_path, test_host_tables_match_reference)."""
    from merlin_zkevm_prover_tpu.ops import ntt_tpu as nt

    if not nt.HAVE_PALLAS:
        pytest.skip("pallas unavailable")
    a = _rand((1 << nbits, cols), 300 + nbits)
    t, j = gl.from_u64(a, CPU), jgl.from_u64(a)
    assert np.array_equal(gl.to_u64(ntt.ntt(t)),
                          jgl.to_u64(nt.ntt_tpu(j, interpret=True)))
    assert np.array_equal(
        gl.to_u64(ntt.extend_pol(t, nbits, nbits + 1)),
        jgl.to_u64(nt.extend_pol_tpu(j, nbits, nbits + 1, interpret=True)))


_K5_FLAGS = {
    # name: (dif, zero_top, sep, canon, const_scale, inverse)
    "dif_inverse": (True, False, False, False, None, True),
    "dif_zero_top": (True, True, False, False, None, False),
    "dit_sep_no_canon": (False, False, True, False, None, True),
    "dit_const": (False, False, False, True, 987654321, True),
    "dit_canon": (False, False, False, True, None, False),
}


def _planes(x):
    import jax.numpy as jnp

    return (jnp.asarray((x & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((x >> np.uint64(32)).astype(np.uint32)))


def _pallas_block(nt, call, log_l, inverse, extras, a):
    """Run a pallas block call on the (rows, cols) matrix `a`, padded to one
    block of the reference's column width; the result reduced modulo p."""
    padded = np.zeros((a.shape[0], nt._BC), dtype=np.uint64)
    padded[:, :a.shape[1]] = a
    tw_lo, tw_hi = nt._stage_tables(log_l, inverse)
    lo, hi = call(tw_lo, tw_hi, extras, *_planes(padded))
    return ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
            | np.asarray(lo).astype(np.uint64))[:, :a.shape[1]] % np.uint64(P)


@pytest.mark.parametrize("flags", list(_K5_FLAGS))
def test_block_matches_pallas_v3_kernel_interpret(flags):
    """The body of the reference's SSA block kernel (`_ntt_kernel_v3`), run
    by the Pallas interpreter on one 256-column block of length 16 (the
    shortest it takes), against the port's block transform with the same
    flags.  The reference's output may be a lazy residue where `canon` is
    off, so both sides are compared reduced modulo p."""
    from merlin_zkevm_prover_tpu.ops import ntt_tpu as nt

    if not nt.HAVE_PALLAS:
        pytest.skip("pallas unavailable")
    dif, zero_top, sep, canon, const_scale, inverse = _K5_FLAGS[flags]
    log_l, cols = 4, 5
    l = 1 << log_l
    in_l = l // 2 if zero_top else l
    a = _rand((in_l, cols), 500 + len(flags))
    a[0, 0], a[1 % in_l, 0], a[2, 0] = P - 1, 0, 1 << 32
    a[:, 1] = 0
    a[1, 1] = 1                                   # one-hot column
    u, v = _rand((l,), 11), _rand((cols,), 12)

    extras = {}
    if sep:
        v_pad = np.zeros((nt._BC,), dtype=np.uint64)
        v_pad[:cols] = v
        extras["u_lo"], extras["u_hi"] = _planes(u[:, None])
        extras["v_lo"], extras["v_hi"] = _planes(v_pad[None, :])
    call = nt._ntt_call_v2(log_l, 1, dif, zero_top, sep, canon, const_scale,
                           True, inverse, True)
    want = _pallas_block(nt, call, log_l, inverse, extras, a)

    kw = dict(zero_top=zero_top, const_scale=const_scale)
    if sep:
        kw.update(u=gl.from_u64(u, CPU), v=gl.from_u64(v, CPU))
    tw = gl.from_u64(ntt_cuda._stage_tables_np(log_l, inverse), CPU)
    got = gl.to_u64(ntt_cuda.ntt_block(gl.from_u64(a, CPU), tw, log_l, dif, **kw))
    assert np.array_equal(got, want)


# Kernel A of the reference's pipeline (`_ntt_v2`) at n_bits 10, 11 and 12,
# the only place its v2 body runs: DIF, unscaled, no canon, forward or
# inverse twiddles, zero_top on the forward LDE.  The LDE reaches kernel A
# with zero_top only at n_bits_ext >= 11, i.e. never at L = 2.
_K6_CASES = [(1, False, False), (1, False, True),
             (2, False, False), (2, False, True), (2, True, False),
             (3, False, False), (3, False, True), (3, True, False)]


@pytest.mark.parametrize("log_l,zero_top,inverse", _K6_CASES)
def test_block_matches_pallas_v2_kernel_interpret(log_l, zero_top, inverse):
    """The body of the reference's radix-2/4 block kernel (`_ntt_kernel_v2`,
    which `_ntt_call_v2` takes below length 16), run by the Pallas
    interpreter on one full 256-column block, against the port's block
    transform with kernel A's flags.  `canon` is off there, so both sides are
    compared reduced modulo p."""
    from merlin_zkevm_prover_tpu.ops import ntt_tpu as nt

    if not nt.HAVE_PALLAS:
        pytest.skip("pallas unavailable")
    l = 1 << log_l
    in_l = l // 2 if zero_top else l
    a = _rand((in_l, nt._BC), 700 + 10 * log_l + 2 * zero_top + inverse)
    a[0, 0], a[-1, 0] = P - 1, 1 << 32
    a[:, 1] = 0
    a[-1, 1] = 1                                  # one-hot column
    call = nt._ntt_call_v2(log_l, 1, True, zero_top, False, False, None, True,
                           inverse)
    want = _pallas_block(nt, call, log_l, inverse, {}, a)
    tw = gl.from_u64(ntt_cuda._stage_tables_np(log_l, inverse), CPU)
    got = ntt_cuda.ntt_block(gl.from_u64(a, CPU), tw, log_l, True,
                             zero_top=zero_top)
    assert np.array_equal(gl.to_u64(got), want)


@pytest.mark.parametrize("nbits", [10, 11])
@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_recursion_equals_plain_radix2(nbits, inverse):
    """The recursion that serves sizes above the pipeline's (n_bits > 18),
    driven directly at sizes just above one block, where it already splits
    into n1 x 512 with the twiddle between the two passes."""
    t = gl.from_u64(_rand((1 << nbits, 2), 600 + nbits), CPU)
    got = ntt_cuda._ntt_rec(t, nbits, inverse)
    want = ntt._ntt_2d(t, nbits, inverse)
    if inverse:                      # the recursion leaves out the 1/N
        got = gl.mul(got, pow(1 << nbits, P - 2, P))
    assert np.array_equal(gl.to_u64(got), gl.to_u64(want))


def test_host_tables_match_reference():
    from merlin_zkevm_prover_tpu.ops import ntt_tpu as nt

    for inv in (False, True):
        assert np.array_equal(ntt_cuda._stage_tables_np(6, inv),
                              nt._stage_tables_np(6, inv))
        assert np.array_equal(ntt_cuda._gather_twiddle_np(2, 5, inv),
                              nt._gather_twiddle_np(2, 5, inv))
    assert np.array_equal(ntt_cuda._mid_gather_idx_np(3, 5),
                          nt._mid_gather_idx_np(3, 5))
    for a, b in zip(ntt_cuda._sep_scale_np(10, 1, SHIFT, True),
                    nt._sep_scale_np(10, 1, SHIFT, True)):
        assert np.array_equal(a, b)
    assert np.array_equal(ntt_cuda._scale_shift_np(5, SHIFT, True),
                          nt._scale_shift_np(5, SHIFT, True))
    assert ntt_cuda._split(13) == nt._split(13) == (4, 9)
    assert ntt_cuda.MAX_KERNEL_BITS == nt.MAX_KERNEL_BITS


@pytest.mark.parametrize("log_l", [1, 2, 4, 6])
@pytest.mark.parametrize("flags", ["dif_inverse", "dif_zero_top", "dit_sep",
                                   "dit_const", "dit_plain"])
def test_block_plain_version_flag_combinations(log_l, flags):
    """Each flag combination of the pipeline, block transform alone,
    against the python-int DFT (bit-reversed on the side the flag says)."""
    l = 1 << log_l
    inverse = flags == "dif_inverse"
    dif = flags.startswith("dif")
    rev = ntt_cuda._bitrev(log_l).astype(np.int64)
    a = _rand((l, 3), 400 + log_l)
    if flags == "dif_zero_top":
        a[l // 2:] = 0
    tw = gl.from_u64(ntt_cuda._stage_tables_np(log_l, inverse), CPU)
    want = np.stack([_naive(a[:, c]) if not inverse else
                     _naive(a[:, c], True) * 0 for c in range(3)], axis=1)
    if inverse:  # unscaled inverse transform
        n_ = np.uint64(l)
        want = np.stack([np.array([int(v) * l % P for v in _naive(a[:, c], True)],
                                  dtype=np.uint64) for c in range(3)], axis=1)
    kw = {}
    if flags == "dit_sep":
        u, v = _rand((l,), 1), _rand((3,), 2)
        kw = dict(u=gl.from_u64(u, CPU), v=gl.from_u64(v, CPU))
        want = np.array([[int(want[r, c]) * int(u[r]) % P * int(v[c]) % P
                          for c in range(3)] for r in range(l)], dtype=np.uint64)
    if flags == "dit_const":
        kw = dict(const_scale=987654321)
        want = np.array([[int(x) * 987654321 % P for x in r] for r in want],
                        dtype=np.uint64)
    if dif:
        x = a[: l // 2] if flags == "dif_zero_top" else a
        got = gl.to_u64(ntt_cuda.ntt_block(
            gl.from_u64(x, CPU), tw, log_l, True,
            zero_top=flags == "dif_zero_top"))
        assert np.array_equal(got, want[rev])
    else:
        got = gl.to_u64(ntt_cuda.ntt_block(gl.from_u64(a[rev], CPU), tw, log_l,
                                           False, **kw))
        assert np.array_equal(got, want)
        if flags == "dit_plain":
            assert np.array_equal(
                gl.to_u64(ntt_cuda.ntt_short(gl.from_u64(a[rev], CPU), tw, log_l)),
                want)


# Closed-form probes.  A multiply that leaves a residue in [p, 2^64) feeding
# an add/sub chain is hit by random operands with probability ~2^-32 per op
# and by one-hot columns every time, so random data cannot replace these.
# 9: one block transform; 13: the pipeline at block lengths 16 and 512.
@pytest.mark.parametrize("nb", [9, 13])
def test_intt_one_hot_all_equal(nb):
    n = 1 << nb
    col = np.zeros((n, 1), dtype=np.uint64)
    col[0, 0] = 1
    out = gl.to_u64(ntt.intt(gl.from_u64(col, CPU)))[:, 0]
    assert np.all(out == np.uint64(pow(n, P - 2, P)))


@pytest.mark.parametrize("nb", [9, 13])
def test_ntt_impulse_constant(nb):
    c = np.zeros((1 << nb, 1), dtype=np.uint64)
    c[0, 0] = 7
    out = gl.to_u64(ntt.ntt(gl.from_u64(c, CPU)))[:, 0]
    assert np.all(out == np.uint64(7))


@pytest.mark.parametrize("nb", [9, 13])
def test_extend_pol_one_hot_lagrange(nb):
    n = 1 << nb
    col = np.zeros((n, 2), dtype=np.uint64)
    col[0, :] = 1

    def L0_at(x):
        num = (pow(x, n, P) - 1) % P
        den = (n * (x - 1)) % P
        return num * pow(den, P - 2, P) % P

    lde = gl.to_u64(ntt.extend_pol(gl.from_u64(col, CPU), nb, nb + 1))[:, 0]
    w_ext = gl.w(nb + 1)
    for j in (0, 1, 3, 191, 192, 193, (1 << (nb + 1)) - 1):
        assert int(lde[j]) == L0_at(SHIFT * pow(w_ext, j, P) % P), f"row {j}"


def test_wrappers_reject_bad_operands():
    tw = gl.from_u64(ntt_cuda._stage_tables_np(3, False), CPU)
    with pytest.raises(ValueError):
        ntt_cuda.ntt_block(torch.zeros((4, 2), dtype=torch.int64), tw, 3, True)
    with pytest.raises(TypeError):
        ntt_cuda.ntt_block(torch.zeros((8, 2), dtype=torch.int32), tw, 3, True)
    with pytest.raises(ValueError):
        ntt_cuda.ntt_short(torch.zeros((8, 2), dtype=torch.int64), tw[:3], 3)
    assert ntt_cuda.LAUNCHES == {"ntt_block": 0, "ntt_block_short": 0,
                                 "ntt_short": 0}
