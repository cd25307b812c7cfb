"""The port's NTT / LDE on the CPU against the JAX plain path, the Pallas
kernels in interpret mode, a python-int DFT and closed-form probes.  All
comparisons are exact (tolerance zero).

On the CPU the port's public functions run the same DIF -> gather -> DIT
pipeline and four-step recursion as on the GPU, with each block kernel
replaced by its plain version; the ``*_plain`` functions are a separate
whole-length radix-2 transform."""

import re
from pathlib import Path

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


# ---------------------------------------------------------------------------
# The kernels of csrc/ntt_gl.cu, which the CPU cannot run, transcribed to
# python ints with their exact index arithmetic (the register form at
# L <= 16, the register passes over the tile at L = 32 .. 512, the column
# layout, the mid gather in kernel B's load, the epilogue) and run on the
# NttArgs fields that the wrappers build for a launch.
# ---------------------------------------------------------------------------

_CSRC = Path(ntt_cuda.__file__).resolve().parent.parent / "csrc" / "ntt_gl.cu"
_M64 = (1 << 64) - 1


def _define(name):
    return int(re.search(rf"^#define {name} (\d+)", _CSRC.read_text(),
                         re.M).group(1))


def _pass_plan(log_l):
    """[(R, BEFORE)] of each pass: PassPlan<LOG_L, P> of ntt_gl.cu."""
    mb = _define("NTT_PASS_MAX_BITS")
    n = (log_l + mb - 1) // mb
    return [(log_l // n + (p < log_l % n),
             p * (log_l // n) + (p if p < log_l % n else log_l % n))
            for p in range(n)]


_EPS = (1 << 32) - 1


def _add_lazy(a, c):
    """gl_add_lazy of goldilocks.cuh on 64-bit words: a any, c canonical."""
    assert 0 <= a <= _M64 and 0 <= c < P
    s = a + c
    if s > _M64:
        s = (s & _M64) + _EPS
        assert s <= _M64                      # no second carry
    return s


def _sub_lazy(a, c):
    """gl_sub_lazy of goldilocks.cuh: a any word, c canonical."""
    assert 0 <= a <= _M64 and 0 <= c < P
    d = a - c
    if d < 0:
        d = d + (1 << 64) - _EPS
        assert d >= 0                         # no second borrow
    return d


def _bitrev_int(x, bits):
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


def _words(t):
    """The whole storage under CPU tensor `t` as python words, and its
    view onto that storage."""
    n = t.untyped_storage().nbytes() // 8
    flat = torch.as_strided(t, (n,), (1,), 0)
    return [v & _M64 for v in flat.tolist()], flat


def _model_launch(f):
    """One launch of merlin_ntt_block on the fields `f`, thread by thread;
    writes into f["out"]'s storage as the kernel does."""
    xb, _ = _words(f["x"])
    ob, oflat = _words(f["out"])
    xo, oo = f["x"].storage_offset(), f["out"].storage_offset()
    tw = [v & _M64 for v in f["tw"].tolist()]
    u = None if f["u"] is None else [v & _M64 for v in f["u"].tolist()]
    v = None if f["v"] is None else [w & _M64 for w in f["v"].tolist()]
    gtw = (None if f["gtw"] is None
           else [w & _M64 for w in f["gtw"].reshape(-1).tolist()])
    log_l, dif, zero_top = f["log_l"], f["dif"], f["zero_top"]
    l, b, c, n1b = 1 << log_l, f["b"], f["c"], f["g_n1_bits"]

    def col_io(j, need_v):
        q = j // c
        cc = j - q * c
        qin = _bitrev_int(q, n1b) if gtw is not None else q
        vj = v[j // f["v_div"]] if (need_v and v is not None) else 1
        return qin * f["x_ld"] + cc, q * f["o_ld"] + cc, q, vj

    def load(io, r):
        if gtw is not None:
            y = xb[xo + io[0] + _bitrev_int(r, log_l) * f["x_rs"]]
            return y * gtw[(r << n1b) + io[2]] % P
        return xb[xo + io[0] + r * f["x_rs"]] % P          # gl_canon

    def store(io, r, val):
        val = val - P if val >= P else val     # gl_canon
        if u is not None:
            val = val * u[r] % P
        if v is not None:
            val = val * io[3] % P
        if f["use_cscale"]:
            val = val * f["cscale"] % P
        ob[oo + io[1] + r * f["o_rs"]] = val

    def bfly(e, i0, i1, t):           # t None: the twiddle is 1
        p_, q_ = e[i0], e[i1]
        if dif:                        # canonical words in and out
            assert p_ < P and q_ < P
            e[i0] = (p_ + q_) % P
            e[i1] = (p_ - q_) % P if t is None else (p_ - q_) * t % P
        else:                          # lazy sums, canonical product
            q_ = q_ - P if (t is None and q_ >= P) else (
                q_ if t is None else q_ * t % P)
            e[i0], e[i1] = _add_lazy(p_, q_), _sub_lazy(p_, q_)

    if log_l <= _define("NTT_REG_MAX_BITS"):      # ntt_reg_kernel
        for j in range(b):
            io = col_io(j, True)
            e = [0 if (zero_top and r >= l // 2) else load(io, r)
                 for r in range(l)]
            for s in range(log_l):
                lm = log_l - 1 - s if dif else s
                m = 1 << lm
                for i in range(l // 2):
                    jj = i & (m - 1)
                    i0 = ((i >> lm) << (lm + 1)) | jj
                    bfly(e, i0, i0 + m, tw[m - 1 + jj] if jj else None)
            for r in range(l):
                store(io, r, e[r])
    else:                                          # ntt_tile_kernel
        log_cols = _define("NTT_LOG_TILE_WORDS") - log_l
        cols = 1 << log_cols

        def word(r, cl):               # tile_word<LOG_COLS>
            return ((r if log_cols >= 4 else r ^ ((r >> 3) & 1)) << log_cols) + cl
        plan = _pass_plan(log_l)
        for blk in range(-(-b // cols)):   # any order: blocks are independent
            c0 = blk * cols
            sm = [0] * (l << log_cols)
            for p, (r_, before) in enumerate(plan):
                k_ = 1 << r_
                q_ = log_l - before - r_ if dif else before
                s_ = 1 << q_
                first, last = p == 0, p == len(plan) - 1
                for w in range((l // k_) << log_cols):
                    cl, g = w & (cols - 1), w >> log_cols
                    base = ((g >> q_) << (q_ + r_)) | (g & (s_ - 1))
                    j = c0 + cl
                    if j >= b:   # dead columns: zeros, never stored
                        continue
                    rows = [base + k * s_ for k in range(k_)]
                    if first:
                        io = col_io(j, last)
                        e = [0 if (zero_top and r >= l // 2) else load(io, r)
                             for r in rows]
                    else:
                        e = [sm[word(r, cl)] for r in rows]
                    blo = base & (s_ - 1)
                    for st in range(r_):
                        t = r_ - 1 - st if dif else st
                        h, m = 1 << t, s_ << t
                        for i in range(k_ // 2):
                            kk = ((i >> t) << (t + 1)) | (i & (h - 1))
                            bfly(e, kk, kk + h, None if m == 1 else
                                 tw[m - 1 + blo + ((kk & (h - 1)) << q_)])
                    if last:
                        io = col_io(j, True)
                        for r, val in zip(rows, e):
                            store(io, r, val)
                    else:
                        for r, val in zip(rows, e):
                            sm[word(r, cl)] = val
    oflat.copy_(torch.tensor([w - (1 << 64) if w >> 63 else w for w in ob],
                             dtype=torch.int64))


def test_kernel_model_mirrors_the_source():
    """The fields of NttArgs in the CUDA struct and in the ctypes mirror,
    in order; and the pass plan: every stage once, radix <= 16, at most
    ceil(log2 L / 3) - 1 barriers between passes."""
    src = _CSRC.read_text()
    body = src[src.index("struct NttArgs {"):]
    body = body[:body.index("};")]
    names = re.findall(r"(\w+)(?=[,;])", re.sub(r"//.*", "", body))
    assert names == [n for n, _ in ntt_cuda._NttArgs._fields_]
    assert _define("NTT_REG_MAX_BITS") == 4
    for log_l in range(5, 10):
        plan = _pass_plan(log_l)
        assert sum(r for r, _ in plan) == log_l and max(r for r, _ in plan) <= 4
        assert [bf for _, bf in plan] == [sum(r for r, _ in plan[:p])
                                          for p in range(len(plan))]
        assert len(plan) - 1 <= -(-log_l // 3) - 1
        assert _define("NTT_LOG_TILE_WORDS") - log_l >= 3  # >= 8 columns
    # the tile's row slots: a bijection, and the two rows a half-warp of an
    # 8-column tile reads (r, r + 1 and r, r + 8, r even) in different
    # halves of the banks
    rows = [r ^ ((r >> 3) & 1) for r in range(512)]
    assert sorted(rows) == list(range(512))
    for r in range(0, 504, 2):
        assert rows[r] % 2 != rows[r + 1] % 2 and rows[r] % 2 != rows[r + 8] % 2


def _edge_words(a):
    """Plant 0, 1, p - 1, p and 2^64 - 1 down the first column and across
    the first row of a uint64 matrix (words >= p are read modulo p)."""
    vals = np.array([0, 1, P - 1, P, (1 << 64) - 1], dtype=np.uint64)
    k = min(len(vals), a.shape[0])
    a[:k, 0] = vals[:k]
    a[0, :min(len(vals), a.shape[1])] = vals[:min(len(vals), a.shape[1])]
    return a


@pytest.mark.parametrize("log_l", list(range(1, 10)))
@pytest.mark.parametrize("flags", ["dif", "dif_zero_top", "dit",
                                   "dit_sep_const"])
def test_kernel_model_block_equals_plain(log_l, flags):
    """Every length 2 .. 512, both directions: the transcribed kernel on
    the fields of an ntt_block launch equals ntt_block_plain."""
    l = 1 << log_l
    dif = flags.startswith("dif")
    zero_top = flags == "dif_zero_top"
    a = _edge_words(_rand((l // 2 if zero_top else l, 3), 900 + log_l))
    a[:, 1] = 0
    a[-1, 1] = 1                                   # one-hot column
    x = gl.from_u64(a, CPU)
    tw = gl.from_u64(ntt_cuda._stage_tables_np(log_l, not dif), CPU)
    kw = dict(zero_top=zero_top, u=None, v=None, const_scale=None)
    if flags == "dit_sep_const":
        kw.update(u=gl.from_u64(_rand((l,), 1), CPU),
                  v=gl.from_u64(_rand((3,), 2), CPU), const_scale=P - 5)
    f = ntt_cuda._block_fields(x, tw, log_l, dif, **kw)
    _model_launch(f)
    want = ntt_cuda.ntt_block_plain(x, tw, log_l, dif, **kw)
    assert np.array_equal(gl.to_u64(f["out"]), gl.to_u64(want))


@pytest.mark.parametrize("n1_bits,n2_bits,c", [(1, 9, 2), (4, 5, 3),
                                               (2, 4, 2), (5, 6, 1)])
def test_kernel_model_pipeline_layouts(n1_bits, n2_bits, c):
    """The pipeline's launches as the wrappers lay them out: kernel A
    reading a column slice of a wider matrix in place (with and without
    zero_top), and kernel B reading kernel A's output through the mid
    gather, with the v[k1] scale, into a column slice; against the plain
    twins, and nothing written outside the slice."""
    n = 1 << (n1_bits + n2_bits)
    wide = gl.from_u64(_edge_words(_rand((n, c + 5), 40 + c)), CPU)
    for zero_top in (False, True):
        xa = wide[: n // 2 if zero_top else n, 2:2 + c]
        f = ntt_cuda._cols_fields(xa, n1_bits, n2_bits, not zero_top, zero_top)
        assert f["x"].data_ptr() == xa.data_ptr()      # read in place
        _model_launch(f)
        want = ntt_cuda.ntt_block_cols_plain(xa, n1_bits, n2_bits,
                                             not zero_top, zero_top)
        assert np.array_equal(gl.to_u64(f["out"]), gl.to_u64(want))
    y = gl.from_u64(_edge_words(_rand((1 << n1_bits, c << n2_bits), 50 + c)),
                    CPU)
    key = (n1_bits + n2_bits, n1_bits, SHIFT, True)
    u = gl.from_u64(ntt_cuda._sep_scale_np(*key)[0], CPU)
    v = gl.from_u64(ntt_cuda._sep_scale_np(*key)[1], CPU)
    out_wide = torch.zeros((n, c + 3), dtype=torch.int64)
    out = out_wide[:, 1:1 + c]
    f = ntt_cuda._gather_fields(y, n1_bits, n2_bits, c, True, u, v, 7, out)
    _model_launch(f)
    want = ntt_cuda.ntt_block_gather_plain(y, n1_bits, n2_bits, c, True, u=u,
                                           v=v, const_scale=7)
    assert np.array_equal(gl.to_u64(out), gl.to_u64(want))
    assert not out_wide[:, 0].any() and not out_wide[:, 1 + c:].any()


def _modelled_kernels(monkeypatch):
    """Route the pipeline's two launches through the transcribed kernel."""
    def cols(x, n1_bits, n2_bits, inverse, zero_top=False):
        f = ntt_cuda._cols_fields(x, n1_bits, n2_bits, inverse, zero_top)
        _model_launch(f)
        return f["out"]

    def gather(y, n1_bits, n2_bits, c, inverse, u=None, v=None,
               const_scale=None, out=None):
        if out is None:
            out = torch.empty((1 << (n1_bits + n2_bits), c), dtype=torch.int64)
        _model_launch(ntt_cuda._gather_fields(y, n1_bits, n2_bits, c, inverse,
                                              u, v, const_scale, out))
        return out
    monkeypatch.setattr(ntt_cuda, "ntt_block_cols", cols)
    monkeypatch.setattr(ntt_cuda, "ntt_block_gather", gather)


@pytest.mark.parametrize("nb", [10, 12])
def test_probes_through_kernel_model(nb, monkeypatch):
    """The one-hot, impulse and Lagrange probes through the pipeline with
    both of its launches run by the transcribed kernel (kernel A at
    L = 2 and 8, B at 512)."""
    _modelled_kernels(monkeypatch)
    n = 1 << nb
    col = np.zeros((n, 2), dtype=np.uint64)
    col[0, 0] = 1
    col[0, 1] = 7
    t = gl.from_u64(col, CPU)
    assert np.all(gl.to_u64(ntt.intt(t))[:, 0] == np.uint64(pow(n, P - 2, P)))
    assert np.all(gl.to_u64(ntt.ntt(t))[:, 1] == np.uint64(7))
    lde = gl.to_u64(ntt.extend_pol_blocked(t, nb, nb + 1, block_cols=1))[:, 0]
    w_ext = gl.w(nb + 1)
    for j in (0, 1, 3, 191, 192, 193, 2 * n - 1):
        x = SHIFT * pow(w_ext, j, P) % P
        want = (pow(x, n, P) - 1) * pow(n * (x - 1) % P, P - 2, P) % P
        assert int(lde[j]) == want, f"row {j}"


@pytest.mark.parametrize("n1_bits,n2_bits,c", [(1, 9, 2), (4, 5, 3),
                                               (9, 9, 1)])
def test_gather_b_plain_matches_mid_gather_and_reference(n1_bits, n2_bits, c):
    """Kernel B's plain twin (the route the CPU takes) equals the port's
    `_mid_gather` followed by the plain block, and the JAX `_mid_gather`
    (plain jnp) followed by the JAX plain transform, with the INTT's
    u[k2] * v[k1] scale and words in [p, 2^64) in the input."""
    from merlin_zkevm_prover_tpu.ops import ntt_tpu as nt

    n1, n2 = 1 << n1_bits, 1 << n2_bits
    nbits = n1_bits + n2_bits
    a = _edge_words(_rand((n1, n2 * c), 60 + nbits))
    a[1, :3] = [P, P + 12345, (1 << 64) - 2]
    y = gl.from_u64(a, CPU)
    u_np, v_np = ntt_cuda._sep_scale_np(nbits, n1_bits, SHIFT, True)
    u, v = gl.from_u64(u_np, CPU), gl.from_u64(v_np, CPU)
    got = gl.to_u64(ntt_cuda.ntt_block_gather(y, n1_bits, n2_bits, c, True,
                                              u=u, v=v))

    z = ntt_cuda._mid_gather(y, n1_bits, n2_bits, c, True)
    tw = gl.from_u64(ntt_cuda._stage_tables_np(n2_bits, True), CPU)
    port = ntt_cuda.ntt_block_plain(z, tw, n2_bits, False, u=u,
                                    v=v.repeat_interleave(c))
    assert np.array_equal(got, gl.to_u64(port).reshape(n1 * n2, c))

    jz = nt._mid_gather(*_planes(a), n1_bits, n2_bits, c, True)
    zr = ((np.asarray(jz[1]).astype(np.uint64) << np.uint64(32))
          | np.asarray(jz[0]).astype(np.uint64)) % np.uint64(P)
    nat = zr[ntt_cuda._bitrev(n2_bits)]          # DIT input is bit-reversed
    ref = jgl.to_u64(jntt._ntt_2d(jgl.from_u64(nat), n2_bits, inverse=True))
    scale = np.array([[int(u_np[k2]) * int(v_np[q // c]) * n2 % P
                       for q in range(n1 * c)] for k2 in range(n2)],
                     dtype=object)            # _ntt_2d's 1/N undone
    want = (ref.astype(object) * scale % P).astype(np.uint64)
    assert np.array_equal(got, want.reshape(n1 * n2, c))


@pytest.mark.parametrize("cols", [67, 130])
def test_extend_pol_blocked_column_slices_match_reference(cols):
    """The blocked LDE with last blocks of 3 and 2 columns, each block's
    columns read from and written into the wide matrices (on the card in
    place), from a column slice of a wider input, against the reference's
    extend_pol_blocked at n_bits = 10."""
    a = _edge_words(_rand((1 << 10, cols + 2), 70 + cols))
    t = gl.from_u64(a, CPU)[:, 1:1 + cols]
    got = gl.to_u64(ntt.extend_pol_blocked(t, 10, 11))
    want = jgl.to_u64(jntt.extend_pol_blocked(
        jgl.from_u64(a[:, 1:1 + cols] % np.uint64(P)), 10, 11))
    assert np.array_equal(got, want)


def test_lazy_add_sub_ranges():
    """gl_add_lazy / gl_sub_lazy (a any word, c canonical) as the
    decimation-in-time butterflies use them: congruent results, no second
    carry or borrow, on the edge words and random words."""
    rng = np.random.default_rng(5)
    edges = [0, 1, _EPS, P - 1, P, _M64 - _EPS, _M64 - 1, _M64]
    a_words = edges + [int(w) for w in rng.integers(0, 1 << 63, 40,
                                                    dtype=np.uint64) * 2]
    c_words = [0, 1, _EPS, P - _EPS, P - 2, P - 1] + [
        int(w) % P for w in rng.integers(0, 1 << 63, 20, dtype=np.uint64)]
    for a in a_words:
        for c in c_words:
            s, d = _add_lazy(a, c), _sub_lazy(a, c)
            assert 0 <= s <= _M64 and s % P == (a + c) % P
            assert 0 <= d <= _M64 and d % P == (a - c) % P
