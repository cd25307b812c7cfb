"""Modules of the port's STARK engine against the JAX package, each on
seeded inputs at a tiny size (n_bits = 5).  All comparisons are exact
(tolerance zero)."""

import dataclasses

import numpy as np
import pytest
import torch

# the suite runs several workers side by side: one thread each
torch.set_num_threads(1)

from merlin_zkevm_prover_tpu.models.smoke import build_smoke_air as ref_build
from merlin_zkevm_prover_tpu.ops import goldilocks as jgl
from merlin_zkevm_prover_tpu.ops import goldilocks3 as jgl3
from merlin_zkevm_prover_tpu.stark import compile_air as ref_compile
from merlin_zkevm_prover_tpu.stark import device_core as jcore
from merlin_zkevm_prover_tpu.stark import fri as jfri
from merlin_zkevm_prover_tpu.stark import plookup as jplookup
from merlin_zkevm_prover_tpu_torch import convert
from merlin_zkevm_prover_tpu_torch.models.smoke import build_smoke_air
from merlin_zkevm_prover_tpu_torch.ops import goldilocks as gl
from merlin_zkevm_prover_tpu_torch.ops import goldilocks3 as gl3
from merlin_zkevm_prover_tpu_torch.stark import compile_air
from merlin_zkevm_prover_tpu_torch.stark import device_core as core
from merlin_zkevm_prover_tpu_torch.stark import evaluator, fri, plookup
from merlin_zkevm_prover_tpu_torch.stark.transcript import Transcript

P = gl.P
CPU = "cpu"
N_BITS = 5
SETTINGS = dict(n_queries=6, final_bits=3, fri_fold_bits=2)


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint64)


@pytest.fixture(scope="module")
def compiled():
    air, trace = build_smoke_air(n_bits=N_BITS, seed=42)
    rair, rtrace = ref_build(n_bits=N_BITS, seed=42)
    assert np.array_equal(trace, rtrace)
    for a, b in zip(air.const_values, rair.const_values):
        assert np.array_equal(a, b)
    return compile_air(air, **SETTINGS), ref_compile(rair, **SETTINGS), air


@pytest.mark.parametrize(
    "field", [f.name for f in dataclasses.fields(
        compile_air(build_smoke_air(n_bits=2, seed=1)[0]))])
def test_stark_info_field_equals_reference(compiled, field):
    info, rinfo, _ = compiled
    carried = convert.stark_info_from_fields(convert.info_fields_of(rinfo))
    assert getattr(info, field) == getattr(carried, field)


def test_prover_from_reference_state(compiled):
    """A port prover built from the numpy state of a reference prover (its
    StarkInfo fields and the limb planes of const_n) equals one built
    directly."""
    info, rinfo, air = compiled
    const = np.stack(air.const_values, axis=1)
    lo = (const & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (const >> np.uint64(32)).astype(np.uint32)
    from merlin_zkevm_prover_tpu_torch.stark import StarkProver

    a = convert.prover_from_reference(convert.info_fields_of(rinfo), lo, hi, CPU)
    b = StarkProver(info, const, device=CPU)
    assert a.const_tree.root() == b.const_tree.root()
    assert np.array_equal(gl.to_u64(a.zi), gl.to_u64(b.zi))
    assert a.info == b.info


def test_calculate_h1h2_with_repeated_values():
    """t has repeated values (tie order decides h1/h2) and f hits them."""
    n = 32
    rng = np.random.default_rng(8)
    t = rng.integers(0, 6, n, dtype=np.uint64) * np.uint64((1 << 63) + 12345)
    t = t % np.uint64(P)
    f = t[rng.integers(0, n, n)]
    h1, h2, ok = plookup.calculate_h1h2(gl.from_u64(f, CPU), gl.from_u64(t, CPU))
    rh1, rh2, rok = jplookup.calculate_h1h2(jgl.from_u64(f), jgl.from_u64(t))
    assert bool(ok) and bool(rok)
    assert np.array_equal(gl.to_u64(h1), jgl.to_u64(rh1))
    assert np.array_equal(gl.to_u64(h2), jgl.to_u64(rh2))
    f[3] = 77  # not in t
    assert not bool(plookup.calculate_h1h2(gl.from_u64(f, CPU),
                                           gl.from_u64(t, CPU))[2])


def test_calculate_h1h2_gl3_keys():
    n = 32
    rng = np.random.default_rng(9)
    t = rng.integers(0, 3, (n, 3), dtype=np.uint64) * np.uint64(P - 1) % np.uint64(P)
    f = t[rng.integers(0, n, n)]
    h1, h2, ok = plookup.calculate_h1h2(gl3.from_u64(f, CPU), gl3.from_u64(t, CPU))
    rh1, rh2, rok = jplookup.calculate_h1h2(jgl3.from_u64(f), jgl3.from_u64(t))
    assert bool(ok) and bool(rok)
    assert np.array_equal(gl3.to_u64(h1), jgl3.to_u64(rh1))
    assert np.array_equal(gl3.to_u64(h2), jgl3.to_u64(rh2))


def test_calculate_z():
    num, den = _rand((32, 3), 1), _rand((32, 3), 2)
    got = gl3.to_u64(plookup.calculate_z(gl3.from_u64(num, CPU),
                                         gl3.from_u64(den, CPU)))
    want = jgl3.to_u64(jplookup.calculate_z(jgl3.from_u64(num),
                                            jgl3.from_u64(den)))
    assert np.array_equal(got, want)
    assert list(got[0]) == [1, 0, 0]


def test_step4_finalize(compiled):
    info, rinfo, _ = compiled
    q, zi = _rand((info.n_ext, 3), 3), _rand((info.n_ext,), 4)
    got = gl.to_u64(core.step4_finalize(info, gl3.from_u64(q, CPU),
                                        gl.from_u64(zi, CPU)))
    want = jgl.to_u64(jcore.step4_finalize(rinfo, jgl3.from_u64(q),
                                           jgl.from_u64(zi)))
    assert np.array_equal(got, want)


def _sections(info, seed):
    names = ("cm1_2ns", "cm2_2ns", "cm3_2ns", "cm4_2ns")
    widths = [info.section_widths[k.replace("_2ns", "_n")] for k in names[:3]]
    widths.append(info.section_widths["cm4_2ns"])
    return {k: _rand((info.n_ext, w), seed + i)
            for i, (k, w) in enumerate(zip(names, widths))}


def test_step5_evals(compiled):
    info, rinfo, _ = compiled
    secs = _sections(info, 20)
    const = _rand((info.n_ext, info.n_constants), 30)
    xi = [int(v) for v in _rand((3,), 31)]
    got = gl3.to_u64(core.step5_evals(
        info, {k: gl.from_u64(v, CPU) for k, v in secs.items()},
        gl.from_u64(const, CPU), gl3.const(*xi, device=CPU)))
    want = jgl3.to_u64(jcore.step5_evals(
        rinfo, {k: jgl.from_u64(v) for k, v in secs.items()},
        jgl.from_u64(const), jgl3.const(*xi)))
    assert got.shape == (len(info.ev_map), 3)
    assert np.array_equal(got, want)


def test_fold_step_and_group_source():
    pol = _rand((64, 3), 40)
    sx = [int(v) for v in _rand((3,), 41)]
    got = fri.fold_step(gl3.from_u64(pol, CPU), 6, 4, gl3.const(*sx, device=CPU),
                        gl.SHIFT_INV)
    want = jfri.fold_step(jgl3.from_u64(pol), 6, 4, jgl3.const(*sx), jgl.SHIFT_INV)
    assert np.array_equal(gl3.to_u64(got), jgl3.to_u64(want))
    assert np.array_equal(
        gl.to_u64(fri.group_source(got, 2)),
        jgl.to_u64(jfri.group_source(want, 2)))


def test_x_div_x_sub_is_the_quotient():
    x = _rand((16,), 50)
    pt = [int(v) for v in _rand((3,), 51)]
    got = gl3.to_u64(core.x_div_x_sub(gl.from_u64(x, CPU),
                                      gl3.const(*pt, device=CPU)))
    # (x - pt) * got == x in GF(p^3)
    back = gl3.mul(gl3.from_u64(got, CPU),
                   gl3.sub(gl3.from_base(gl.from_u64(x, CPU)),
                           gl3.const(*pt, device=CPU)))
    assert np.array_equal(gl3.to_u64(back)[:, 0], x)
    assert not gl3.to_u64(back)[:, 1:].any()


def test_roll_and_primed_columns(compiled):
    info, _, _ = compiled
    a = gl.from_u64(np.arange(8, dtype=np.uint64), CPU)
    assert list(gl.to_u64(evaluator.roll_gl(a, 2))) == [2, 3, 4, 5, 6, 7, 0, 1]
    blow = 1 << info.blowup_bits
    ctx = evaluator.EvalContext(
        info=info, domain="ext",
        sections={"cm1_2ns": gl.from_u64(
            np.arange(info.n_ext * info.section_widths["cm1_n"],
                      dtype=np.uint64).reshape(info.n_ext, -1), CPU)},
        const=gl.zeros((info.n_ext, info.n_constants), CPU))
    v = gl.to_u64(ctx.cm_value(0, prime=False))
    vp = gl.to_u64(ctx.cm_value(0, prime=True))
    assert np.array_equal(vp, np.roll(v, -blow))


def test_transcript_matches_reference():
    from merlin_zkevm_prover_tpu.stark.transcript import Transcript as RefT

    a, b = Transcript(), RefT()
    for t in (a, b):
        t.put([1, 2, 3, P - 1])
        t.put(list(range(20)))
    assert a.get_field() == b.get_field()
    assert a.get_permutations(6, 7) == b.get_permutations(6, 7)
