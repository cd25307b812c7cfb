"""The port's final hop (snark/*, recursion/final*, stark/prover_bn128)
against the JAX package's.

Tolerance: none.  Every value is a BN254 or Goldilocks field element, so
every comparison is exact equality of python ints.

No test here runs the JAX MSM, FFT or ``scalar_mul_table`` jit on the CPU
(minutes of XLA compile each).  The JAX side comes from the JAX package's
host python modules (pairing, setup's scalars, build_final_r1cs, the
python-int curve oracle below) and from two golden files that the JAX
package writes:

    MERLIN_WRITE_GOLDEN=1 MERLIN_STEP_MAX_NODES=12 MERLIN_STEP5_MATRIX_MIN=0 \
        python tests/test_torch_snark.py

``torch_bn128_proof.json`` is the StarkProverBN128 proof of the
``n_bits = 3`` smoke circuit at the settings of tests/test_final_stage.py;
``torch_groth16_final.json`` is the Groth16 proof over that proof's final
R1CS (``setup_seed = 1234``, fixed ``r`` and ``s``), with the key's
verifying points and the heads and tails of its point tables.  The JAX
package's jitted Groth16 on the CPU takes hours of XLA, so the committed
file is written in the exponent by its host python
(``python tests/test_torch_snark.py exponent``, groth16_in_the_exponent).
``chip_smoke.py`` (phase ``golden_final``) and tests/test_torch_gpu_final.py
prove both on the card and hold them against the same files.
"""

import json
import random
import os
import sys
import time

import numpy as np
import pytest
import torch

# the suite runs several workers side by side: one thread each
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
BN128_NBITS = 3
BN128_SEED = 3
BN128_SETTINGS = dict(n_queries=2, final_bits=2, fri_fold_bits=1)
SETUP_SEED = 1234
# fixed Groth16 blinding (groth16.prove draws them from `secrets` otherwise)
R_BLIND = 0x1F2E3D4C5B6A79881726354453627180918273645546372819
S_BLIND = 0x0A1B2C3D4E5F60718293A4B5C6D7E8F90123456789ABCDEF01
TABLE_EDGE = 3   # points kept from each end of every table
PROOF_FIELDS = ("roots", "evals", "fri_roots", "final_pol", "queries_step0",
                "queries_fri", "publics")
BN128_GOLDEN = os.path.join(DATA, "torch_bn128_proof.json")
GROTH16_GOLDEN = os.path.join(DATA, "torch_groth16_final.json")


def write_golden() -> None:
    """Prove the final hop with the JAX package on the CPU and save it."""
    if os.environ.get("MERLIN_WRITE_GOLDEN") != "1":
        raise RuntimeError("set MERLIN_WRITE_GOLDEN=1 to run the JAX prover")
    import tests.conftest  # noqa: F401  (JAX on the CPU, x64 on)
    from merlin_zkevm_prover_tpu.models.smoke import (build_smoke_air,
                                                      smoke_const_values)
    from merlin_zkevm_prover_tpu.recursion.final_circuit import build_final_r1cs
    from merlin_zkevm_prover_tpu.snark import curve, groth16
    from merlin_zkevm_prover_tpu.snark.curve import F1, F2
    from merlin_zkevm_prover_tpu.snark.pairing import groth16_verify, make_vk
    from merlin_zkevm_prover_tpu.snark.setup import setup
    from merlin_zkevm_prover_tpu.stark import compile_air, verify
    from merlin_zkevm_prover_tpu.stark.prover_bn128 import (
        MerkleTreeBN128GL, StarkProverBN128, TranscriptBN128Adapter)

    t0 = time.time()
    air, trace = build_smoke_air(n_bits=BN128_NBITS, seed=BN128_SEED)
    info = compile_air(air, **BN128_SETTINGS)
    prover = StarkProverBN128(info, smoke_const_values(air))
    proof = prover.prove(trace)
    const_root = prover.const_tree.root()
    assert verify(info, const_root, proof, tree_cls=MerkleTreeBN128GL,
                  transcript_cls=TranscriptBN128Adapter)
    t_stark = time.time() - t0
    print(f"recursiveF proof: {t_stark:.1f} s", flush=True)
    os.makedirs(DATA, exist_ok=True)
    with open(BN128_GOLDEN, "w") as f:
        json.dump({"writer": "merlin_zkevm_prover_tpu.stark.prover_bn128 "
                             "(JAX, CPU)",
                   "reference_env": {k: os.environ[k] for k in sorted(os.environ)
                                     if k.startswith("MERLIN_STEP")},
                   "n_bits": BN128_NBITS, "seed": BN128_SEED,
                   "compile_air": BN128_SETTINGS, "seconds": t_stark,
                   "const_root": const_root,
                   "proof": json.loads(proof.to_json())},
                  f, separators=(",", ":"))

    t1 = time.time()
    r1cs, witness = build_final_r1cs(info, const_root[0], proof)
    t_r1cs = time.time() - t1
    print(f"r1cs: {len(r1cs.a)} constraints, {r1cs.n_vars} vars, "
          f"{t_r1cs:.1f} s", flush=True)
    key, toxic = setup(r1cs, seed=SETUP_SEED)
    t_setup = time.time() - t1 - t_r1cs
    print(f"setup: {t_setup:.1f} s", flush=True)
    g16 = groth16.prove(key, witness, r=R_BLIND, s=S_BLIND)
    g16["publics"] = witness[1: r1cs.n_public + 1]
    assert groth16_verify(make_vk(toxic, r1cs.n_public), g16)
    t_prove = time.time() - t1 - t_r1cs - t_setup

    def aff(F, p):
        x, y, inf = curve.to_affine(F, p)
        if bool(np.asarray(inf).reshape(-1)[0]):
            return None
        if F is F1:
            return [int(np.asarray(F1.to_int(x)).reshape(-1)[0]),
                    int(np.asarray(F1.to_int(y)).reshape(-1)[0])]
        return [[int(np.asarray(c).reshape(-1)[0]) for c in F2.to_int(x)],
                [int(np.asarray(c).reshape(-1)[0]) for c in F2.to_int(y)]]

    def edge_points(F, table):
        import jax

        n = jax.tree_util.tree_leaves(table.x)[0].shape[0]
        idx = sorted(set(range(min(TABLE_EDGE, n)))
                     | set(range(max(n - TABLE_EDGE, 0), n)))
        return {str(i): aff(F, jax.tree_util.tree_map(lambda a: a[i], table))
                for i in idx}

    doc = {
        "writer": "merlin_zkevm_prover_tpu.snark (JAX, CPU)",
        "setup_seed": SETUP_SEED, "r": R_BLIND, "s": S_BLIND,
        "n_constraints": len(r1cs.a), "n_vars": r1cs.n_vars,
        "n_public": r1cs.n_public, "domain_bits": key.domain_bits,
        "seconds": {"r1cs": t_r1cs, "setup": t_setup, "prove": t_prove},
        "toxic": {k: toxic[k] for k in ("tau", "alpha", "beta", "delta")},
        "vk": {"alpha1": aff(F1, key.vk_alpha1), "beta1": aff(F1, key.vk_beta1),
               "delta1": aff(F1, key.vk_delta1), "beta2": aff(F2, key.vk_beta2),
               "delta2": aff(F2, key.vk_delta2)},
        "tables": {"points_a": edge_points(F1, key.points_a),
                   "points_b1": edge_points(F1, key.points_b1),
                   "points_b2": edge_points(F2, key.points_b2),
                   "points_c": edge_points(F1, key.points_c),
                   "points_h": edge_points(F1, key.points_h)},
        "proof": {k: g16[k] for k in ("pi_a", "pi_b", "pi_c", "publics")},
    }
    with open(GROTH16_GOLDEN, "w") as f:
        json.dump(doc, f, separators=(",", ":"))


def groth16_in_the_exponent(r1cs, witness, setup_seed, r, s):
    """The reference setup's key and the reference prover's proof for
    (r1cs, witness, r, s), computed in the exponent with the JAX package's
    host python (setup's Lagrange evaluations and scalar loops, pairing's
    python-int scalar multiplication) and no jit: the proof's exponents are
    pi_a = alpha + A(tau) + r delta, pi_b = beta + B(tau) + s delta over
    G2, and pi_c = (sum_priv w_i (beta u_i + alpha v_i + w_i) + A(tau)
    B(tau) - C(tau)) / delta + s pi_a + r pi_b1 - r s delta, pi_b1 the
    exponent of pi_b over G1.  Returns the golden document's fields and
    the toxic waste (setup's u, v, w with it)."""
    import random as _random

    from merlin_zkevm_prover_tpu.snark import fft as ref_fft
    from merlin_zkevm_prover_tpu.snark.pairing import (G1_GEN, G2_GEN, R,
                                                       g1_mul, g2_mul)
    from merlin_zkevm_prover_tpu.snark.setup import _lagrange_evals_at

    rng = _random.Random(setup_seed)           # the order of setup's draws
    tau, alpha, beta, delta = (rng.randrange(1, R) for _ in range(4))
    n_cons = len(r1cs.a)
    domain_bits = max((n_cons - 1).bit_length(), 1)
    n = 1 << domain_bits
    lag = _lagrange_evals_at(tau, n, R)
    u, v, wv = ([0] * r1cs.n_vars for _ in range(3))
    for c in range(n_cons):
        for acc, rows in ((u, r1cs.a), (v, r1cs.b), (wv, r1cs.c)):
            for sig, coef in rows[c].items():
                acc[sig] = (acc[sig] + coef * lag[c]) % R
    a_tau = sum(w * x for w, x in zip(witness, u)) % R
    b_tau = sum(w * x for w, x in zip(witness, v)) % R
    c_tau = sum(w * x for w, x in zip(witness, wv)) % R
    dinv = pow(delta, R - 2, R)
    priv = range(r1cs.n_public + 1, r1cs.n_vars)
    c_scal = [(beta * u[i] + alpha * v[i] + wv[i]) % R * dinv % R
              for i in priv]
    a_exp = (alpha + a_tau + r * delta) % R
    b_exp = (beta + b_tau + s * delta) % R
    c_exp = ((sum(witness[i] * c_scal[k] for k, i in enumerate(priv))
              + (a_tau * b_tau - c_tau) * dinv + s * a_exp + r * b_exp
              - r * s * delta) % R)

    def h_scalar(k):                 # the reference setup's loop, at k
        eta = ref_fft.w_fr(domain_bits + 1)
        xk = eta * pow(ref_fft.w_fr(domain_bits), k, R) % R
        z_tau = (pow(tau, n, R) - 1) % R
        zc_tau = (pow(tau, n, R) + 1) % R
        lck = zc_tau * xk % R * pow(n, R - 2, R) % R
        lck = lck * pow((tau - xk) % R, R - 2, R) % R
        lck = lck * pow(pow(xk, n, R), R - 2, R) % R
        z_xk = (pow(xk, n, R) - 1) % R
        return lck * z_tau % R * pow(z_xk, R - 2, R) % R * dinv % R

    def ends(m):
        return sorted(set(range(min(TABLE_EDGE, m)))
                      | set(range(max(m - TABLE_EDGE, 0), m)))

    def aff1(e):
        p = g1_mul(e % R, G1_GEN)
        return None if p is None else [p[0], p[1]]

    def aff2(e):
        p = g2_mul(e % R, G2_GEN)
        return None if p is None else [list(p[0]), list(p[1])]

    pa, pb, pc = aff1(a_exp), aff2(b_exp), aff1(c_exp)
    toxic = {"tau": tau, "alpha": alpha, "beta": beta, "delta": delta,
             "u": u, "v": v, "w": wv}
    return toxic, {
        "n_constraints": n_cons, "n_vars": r1cs.n_vars,
        "n_public": r1cs.n_public, "domain_bits": domain_bits,
        "toxic": {"tau": tau, "alpha": alpha, "beta": beta, "delta": delta},
        "vk": {"alpha1": aff1(alpha), "beta1": aff1(beta),
               "delta1": aff1(delta), "beta2": aff2(beta),
               "delta2": aff2(delta)},
        "tables": {
            "points_a": {str(i): aff1(u[i]) for i in ends(r1cs.n_vars)},
            "points_b1": {str(i): aff1(v[i]) for i in ends(r1cs.n_vars)},
            "points_b2": {str(i): aff2(v[i]) for i in ends(r1cs.n_vars)},
            "points_c": {str(i): aff1(c_scal[i]) for i in ends(len(c_scal))},
            "points_h": {str(k): aff1(h_scalar(k)) for k in ends(n)}},
        "proof": {"pi_a": [pa[0], pa[1], 1],
                  "pi_b": [pb[0], pb[1], [1, 0]],
                  "pi_c": [pc[0], pc[1], 1],
                  "publics": witness[1: r1cs.n_public + 1]},
    }


def write_golden_in_the_exponent() -> None:
    """torch_groth16_final.json from the golden recursiveF proof with the
    JAX package's host python only (groth16_in_the_exponent), checked by
    the reference's pairing: the Groth16 proof that the reference's jitted
    setup and prover reach, written without their hours of XLA compile on
    the CPU."""
    if os.environ.get("MERLIN_WRITE_GOLDEN") != "1":
        raise RuntimeError("set MERLIN_WRITE_GOLDEN=1 to write golden files")
    import tests.conftest  # noqa: F401  (JAX on the CPU, x64 on)
    from merlin_zkevm_prover_tpu.models.smoke import build_smoke_air
    from merlin_zkevm_prover_tpu.recursion.final_circuit import build_final_r1cs
    from merlin_zkevm_prover_tpu.snark.pairing import groth16_verify, make_vk
    from merlin_zkevm_prover_tpu.stark import compile_air
    from merlin_zkevm_prover_tpu.stark.proof import StarkProof

    t0 = time.time()
    with open(BN128_GOLDEN) as f:
        g = json.load(f)
    air, _ = build_smoke_air(n_bits=g["n_bits"], seed=g["seed"])
    info = compile_air(air, **g["compile_air"])
    r1cs, witness = build_final_r1cs(
        info, g["const_root"][0], StarkProof.from_json(json.dumps(g["proof"])))
    toxic, doc = groth16_in_the_exponent(r1cs, witness, SETUP_SEED, R_BLIND,
                                         S_BLIND)
    assert groth16_verify(make_vk(toxic, r1cs.n_public), doc["proof"])
    doc = {"writer": "merlin_zkevm_prover_tpu host python: setup's scalars, "
                     "pairing's scalar multiplication (the proof in the "
                     "exponent)",
           "setup_seed": SETUP_SEED, "r": R_BLIND, "s": S_BLIND,
           "seconds": time.time() - t0, **doc}
    with open(GROTH16_GOLDEN, "w") as f:
        json.dump(doc, f, separators=(",", ":"))


if __name__ == "__main__":
    if sys.argv[1:] == ["exponent"]:
        write_golden_in_the_exponent()
    else:
        write_golden()
    sys.exit(0)


import merlin_zkevm_prover_tpu.recursion.final_circuit as ref_fc  # noqa: E402
import merlin_zkevm_prover_tpu.snark.binfile as ref_binfile  # noqa: E402
import merlin_zkevm_prover_tpu.snark.groth16 as ref_groth16  # noqa: E402
import merlin_zkevm_prover_tpu.snark.setup as ref_setup  # noqa: E402
from merlin_zkevm_prover_tpu.models.smoke import build_smoke_air as ref_smoke  # noqa: E402
from merlin_zkevm_prover_tpu.stark import compile_air as ref_compile  # noqa: E402
from merlin_zkevm_prover_tpu.stark.proof import StarkProof as RefProof  # noqa: E402

from merlin_zkevm_prover_tpu_torch import convert  # noqa: E402
from merlin_zkevm_prover_tpu_torch.models.smoke import build_smoke_air  # noqa: E402
from merlin_zkevm_prover_tpu_torch.ops import bn254_cuda  # noqa: E402
from merlin_zkevm_prover_tpu_torch.ops import bn254_field as bf  # noqa: E402
from merlin_zkevm_prover_tpu_torch.recursion import final_circuit as fc  # noqa: E402
from merlin_zkevm_prover_tpu_torch.recursion.final import FinalStage  # noqa: E402
from merlin_zkevm_prover_tpu_torch.snark import binfile, curve, fft, groth16, msm  # noqa: E402
from merlin_zkevm_prover_tpu_torch.snark import pairing as pr  # noqa: E402
from merlin_zkevm_prover_tpu_torch.snark import setup as port_setup  # noqa: E402
from merlin_zkevm_prover_tpu_torch.snark.curve import F1, F2  # noqa: E402
from merlin_zkevm_prover_tpu_torch.stark import StarkProof, compile_air  # noqa: E402
from merlin_zkevm_prover_tpu_torch.tools import bn254_times as bnt  # noqa: E402
from merlin_zkevm_prover_tpu_torch.utils.timer import TimerLog  # noqa: E402

R = bf.R_MOD
Q = bf.Q


# ---- the affine python oracle of tests/test_snark.py:15-50 ----
def aff_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    if p[0] == q[0] and (p[1] + q[1]) % Q == 0:
        return None
    if p == q:
        lam = (3 * p[0] * p[0]) * pow(2 * p[1], -1, Q) % Q
    else:
        lam = (q[1] - p[1]) * pow(q[0] - p[0], -1, Q) % Q
    x = (lam * lam - p[0] - q[0]) % Q
    y = (lam * (p[0] - x) - p[1]) % Q
    return (x, y)


def aff_mul(p, e):
    acc = None
    base = p
    while e:
        if e & 1:
            acc = aff_add(acc, base)
        e >>= 1
        base = aff_add(base, base)
    return acc


G = (1, 2)


def g1(device="cpu"):
    return curve.g1_generator(device)


def one(F, p):
    return curve.affine_ints(F, curve.Point(*[curve._unsqueeze1(F, leaf)
                                              for leaf in p]))[0]


def scalars(vals):
    return bf.scalars_to_limbs(vals, "cpu")


# ---------------------------------------------------------------------------
# (a) curve arithmetic and kernel B4's twin
# ---------------------------------------------------------------------------


def test_curve_add_double_match_oracle():
    g = g1()
    g2 = curve.double(F1, g)
    assert one(F1, g2) == aff_add(G, G)
    assert one(F1, curve.add(F1, g2, g)) == aff_mul(G, 3)
    assert one(F1, curve.add(F1, g2, g2)) == aff_mul(G, 4)   # the doubling
    assert one(F1, curve.add(F1, g, curve.neg(F1, g))) is None
    inf = curve.infinity(F1, (), "cpu")
    assert one(F1, curve.add(F1, inf, g)) == G
    assert one(F1, curve.add(F1, g, inf)) == G
    assert one(F1, curve.double(F1, inf)) is None


def test_g2_generator_on_curve():
    """y^2 = x^3 + 3 / (9 + u) over Fq2, in python ints."""
    (x0, x1), (y0, y1) = one(F2, curve.g2_generator("cpu"))

    def mul(a, b):
        return ((a[0] * b[0] - a[1] * b[1]) % Q, (a[0] * b[1] + a[1] * b[0]) % Q)

    inv = pow(81 + 1, -1, Q)
    b2 = (3 * 9 * inv % Q, (-3) * inv % Q)
    x, y = (x0, x1), (y0, y1)
    lhs = mul(y, y)
    rhs = mul(mul(x, x), x)
    assert lhs == ((rhs[0] + b2[0]) % Q, (rhs[1] + b2[1]) % Q)


def test_scalar_mul_table_twin_matches_oracle():
    es = [5, 123456789, R - 1, 0, 1, 2 ** 200 + 7]
    got = curve.affine_ints(F1, curve.scalar_mul_table(F1, g1(), es))
    assert got == [aff_mul(G, e) for e in es]
    assert one(F1, curve.scalar_mul(F1, g1(), 77)) == aff_mul(G, 77)


# ---- kernel B4's signed digits and affine tables (python ints) ----


def _recode(e, w):
    """Signed w-bit windows of e, the textbook way: d = e mod 2^w, less
    2^w above 2^(w-1), then e = (e - d) / 2^w."""
    out = []
    for _ in range(curve.fixed_base_windows(w)):
        d = e % (1 << w)
        if d > 1 << (w - 1):
            d -= 1 << w
        out.append(d)
        e = (e - d) >> w
    assert e == 0
    return out


@pytest.mark.parametrize("w", [6, 7, 8, 10])
def test_signed_digits_match_the_recoding(w):
    half = 1 << (w - 1)
    n_low = 256 // w
    all_half = sum(half << (w * j) for j in range(n_low))
    all_above = sum((half + 1) << (w * j) for j in range(n_low))
    es = [0, 1, R - 1, R, (1 << 256) - 1, all_half, all_above] + \
        [1 << k for k in range(256)] + [R - (1 << k) for k in range(254)]
    for e in es:
        ds = curve.signed_digits(e, w)
        assert ds == _recode(e, w)
        assert sum(d << (w * j) for j, d in enumerate(ds)) == e
        assert all(-half < d <= half for d in ds)
    assert curve.signed_digits(all_half, w) == [half] * n_low + [0]
    ds = curve.signed_digits(all_above, w)
    assert ds[0] == -(half - 1) and ds[-1] == 1
    assert curve.signed_digits((1 << 256) - 1, w)[-1] == 1 << (256 % w)
    # the bound's vectorised count of nonzero digits
    got = bnt.digit_counts(bf.scalars_to_limbs(es, "cpu"), w)
    assert got.tolist() == [sum(1 for d in curve.signed_digits(e, w) if d)
                            for e in es]


def _g2_ints(p):
    return None if p is None else (tuple(p[0]), tuple(p[1]))


@pytest.mark.parametrize("group", ["G1", "G2"])
def test_fixed_base_table_matches_python_multiples(group):
    """Entry j 2^(w-1) + d - 1 is d 2^(w j) P, at the kernel's width."""
    w = curve.FB_WINDOW
    half, n_win = 1 << (w - 1), curve.fixed_base_windows(w)
    g2 = group == "G2"
    base = pr.G2_GEN if g2 else G
    table = curve.fixed_base_table_ints(g2, base, w)
    assert len(table) == n_win * half
    mul = (lambda k: _g2_ints(pr.g2_mul(k, pr.G2_GEN))) if g2 else \
        (lambda k: aff_mul(G, k % R))
    for j in (0, 1, n_win // 2, n_win - 1):
        for d in (1, 2, 3, half - 1, half):
            got = table[j * half + d - 1]
            assert (_g2_ints(got) if g2 else got) == mul(d << (w * j))


@pytest.mark.parametrize("group", ["G1", "G2"])
def test_fixed_base_table_tensor_layout(group):
    """The device table: x then y (c0, c1 each over Fq2), Montgomery form,
    an x of all ones for infinity; the same points from a base in other
    Jacobian coordinates."""
    F = F2 if group == "G2" else F1
    gen = curve.g2_generator("cpu") if F is F2 else g1()
    w = 4
    want = curve.fixed_base_table_ints(F is F2, pr.G2_GEN if F is F2 else G, w)
    zs = F.split(F.from_int((5, 7) if F is F2 else 5, "cpu"))
    (z2,) = F.mul_many([(zs, zs)])
    (z3,) = F.mul_many([(z2, zs)])
    x, y = F.mul_many([(F.split(gen.x), z2), (F.split(gen.y), z3)])
    moved = curve.join_point(F, curve.Point(x, y, zs))   # (x z^2, y z^3, z)
    for base in (gen, moved):
        table = curve.fixed_base_table(F, base, w)
        assert tuple(table.shape) == (len(want), 4 * (4 if F is F2 else 2))
        rinv = pow(bf.FQ.r, -1, Q)
        v = [x * rinv % Q for x in bf.limbs_to_ints(table.reshape(-1, 4))]
        k = 4 if F is F2 else 2
        got = []
        for i in range(len(want)):
            e = v[k * i:k * i + k]
            raw = bf.limbs_to_ints(table[i].reshape(-1, 4))
            if raw[0] == (1 << 256) - 1:
                assert not any(raw[k // 2:])
                got.append(None)
            elif F is F2:
                got.append(((e[0], e[1]), (e[2], e[3])))
            else:
                got.append((e[0], e[1]))
        assert got == want
    inf = curve.infinity(F, (), "cpu")
    table = curve.fixed_base_table(F, inf, w)
    half = table.shape[1] // 2
    assert bool((table[:, :half] == -1).all())
    assert not bool(table[:, half:].any())


def test_fixed_base_table_cache_reused_per_base():
    curve._FB_TABLES.clear()
    g = g1()
    t1 = curve.fixed_base_table(F1, g, 4)
    assert curve.fixed_base_table(F1, g, 4) is t1
    assert curve.fixed_base_table(F1, g1(), 4) is t1      # the same words
    assert curve.fixed_base_table(F1, g, 5) is not t1     # another width
    g2x = curve.double(F1, g)
    assert not torch.equal(curve.fixed_base_table(F1, g2x, 4)[:2], t1[:2])
    bases = [g]
    for _ in range(curve.FB_TABLES_KEPT):
        bases.append(curve.add(F1, bases[-1], g))
        curve.fixed_base_table(F1, bases[-1], 4)
    assert len(curve._FB_TABLES) == curve.FB_TABLES_KEPT
    assert curve.fixed_base_table(F1, g, 4) is not t1     # evicted, rebuilt
    assert torch.equal(curve.fixed_base_table(F1, g, 4), t1)
    curve._FB_TABLES.clear()


@pytest.mark.parametrize("wide", [True, False], ids=["FB_WINDOW", "small"])
@pytest.mark.parametrize("group", ["G1", "G2"])
def test_fixed_base_walk_model_at_edge_scalars(group, wide):
    """B4's walk in python ints (its digits, its table, y negated for a
    negative digit, a complete affine sum) gives e P at the edge scalars
    chip_smoke.py holds the kernel at, among them walks whose accumulator
    meets the point it adds and its negation."""
    w = curve.FB_WINDOW if wide else curve.FB_WINDOW_SMALL
    half = 1 << (w - 1)
    g2 = group == "G2"
    base = pr.G2_GEN if g2 else G
    table = curve.fixed_base_table_ints(g2, base, w)
    add = pr.g2_add if g2 else aff_add
    es = bnt.edge_scalars(w)
    kinds = {k for e in es for k in bnt.meet_kinds(e, w)}
    assert kinds == {"equal", "opposite"}
    if g2:      # the slow G2 oracle on the meeting walks and a few edges
        es = [e for e in es if bnt.meet_kinds(e, w)] + \
            [0, 1, R - 1, (1 << 256) - 1]
    for e in es:
        acc = None
        for j, d in enumerate(curve.signed_digits(e, w)):
            if d:
                p = table[j * half + abs(d) - 1]
                if d < 0:
                    p = (p[0], pr.f2_neg(p[1]) if g2 else (-p[1]) % Q)
                acc = add(acc, p)
        want = _g2_ints(pr.g2_mul(e, pr.G2_GEN)) if g2 else aff_mul(G, e % R)
        assert (_g2_ints(acc) if g2 else acc) == want


# ---------------------------------------------------------------------------
# (b) kernel B2's twin: the Fr NTT, the coset scale, the power tables
# ---------------------------------------------------------------------------


def _dft(vals, root):
    n = len(vals)
    return [sum(v * pow(root, i * k, R) for i, v in enumerate(vals)) % R
            for k in range(n)]


@pytest.mark.parametrize("log_n", [0, 1, 3, 6])
def test_fft_twin_matches_python_dft(log_n):
    n = 1 << log_n
    rnd = random.Random(log_n)
    vals = [R - 1, 0, 1][:n] + [rnd.randrange(R) for _ in range(n - min(n, 3))]
    a = bf.from_int(bf.FR, vals, "cpu")
    w = fft.w_fr(log_n)
    assert list(bf.to_int(bf.FR, fft.fft(a))) == _dft(vals, w)
    n_inv = pow(n, R - 2, R)
    assert list(bf.to_int(bf.FR, fft.ifft(a))) == \
        [v * n_inv % R for v in _dft(vals, pow(w, R - 2, R))]
    assert list(bf.to_int(bf.FR, fft.ifft(fft.fft(a)))) == vals


def test_coset_scale_and_powers_twins():
    vals = [3, R - 1, 0, 12345]
    got = bf.to_int(bf.FR, fft.coset_scale(bf.from_int(bf.FR, vals, "cpu"), 5))
    assert list(got) == [v * pow(5, i, R) % R for i, v in enumerate(vals)]
    pw = bn254_cuda.powers(fft.w_fr(5), 37, start=9, device="cpu")
    assert list(bf.to_int(bf.FR, pw)) == \
        [9 * pow(fft.w_fr(5), i, R) % R for i in range(37)]
    a = bf.from_int(bf.FR, vals, "cpu")
    b = bf.from_int(bf.FR, vals[::-1], "cpu")
    assert list(bf.to_int(bf.FR, bn254_cuda.mul_sub(a, b, a))) == \
        [(x * y - x) % R for x, y in zip(vals, vals[::-1])]


def _csrc_define(name, source):
    """The value of a ``#define`` of csrc/<source>."""
    import re

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "merlin_zkevm_prover_tpu_torch", "csrc", source)
    with open(path) as f:
        return int(re.search(rf"^#define {name} (\d+)", f.read(), re.M).group(1))


@pytest.mark.parametrize("log_n", list(range(1, 25)))
def test_ntt_pass_plan(log_n):
    """ntt_passes at every log2 n from 1 to 24: the passes take every stage
    once, in order, each at most NTT_TILE_BITS; a tile's bits below s0 are
    there, and a tile fits the kernel's shared memory."""
    k = fft.NTT_TILE_BITS
    assert k <= _csrc_define("BN_NTT_MAX_TILE_BITS", "bn254_ntt.cu")
    plan = fft.ntt_passes(log_n)
    assert len(plan) == -(-log_n // k)
    s0 = 0
    for p_, (start, kp, cb) in enumerate(plan):
        assert start == s0 and 1 <= kp <= k and 0 <= cb <= start
        assert kp + cb <= k
        assert cb == min(k - kp, start)
        s0 += kp
    assert s0 == log_n
    assert max(kp for _, kp, _ in plan) - min(kp for _, kp, _ in plan) <= 1


def _model_ntt(a, inverse, k):
    """bn_fr_ntt_pass_kernel's index arithmetic (tiles, the first pass's
    bit-reversed gather, each stage's butterflies and twiddle index, the
    inverse's 1/n at the last store) over the passes of ntt_passes(., k),
    in the plain arithmetic."""
    nbits = a.shape[0].bit_length() - 1
    n = 1 << nbits
    tw = bf.to16(fft._twiddles(nbits, inverse, "cpu"))
    src16 = bf.to16(a)
    out = torch.zeros_like(src16)
    passes = fft.ntt_passes(nbits, k)
    for p_, (s0, kp, cb) in enumerate(passes):
        size = 1 << (kp + cb)
        n_high = 1 << (nbits - s0 - kp)
        blk = torch.arange(1 << (nbits - kp - cb))
        h, low0 = blk % n_high, (blk // n_high) << cb
        e = torch.arange(size)
        idx = (h[:, None] << (s0 + kp)) | ((e >> cb)[None] << s0) | \
            (low0[:, None] + (e & ((1 << cb) - 1))[None])
        gather = fft._bitrev(nbits, "cpu")[idx] if s0 == 0 else idx
        tile = (src16 if p_ == 0 else out)[gather]
        for l in range(1, kp + 1):
            hl = 1 << (l - 1)
            bfly = torch.arange(size // 2)
            v, b = bfly & ((1 << cb) - 1), bfly >> cb
            bm = b & (hl - 1)
            e1 = ((((b >> (l - 1)) << l) | bm) << cb) | v
            e2 = e1 + (hl << cb)
            kk = (bm[None] << s0) + low0[:, None] + v[None]
            x = bf.mul16(bf.FR, tile[:, e2], tw[kk << (nbits - s0 - l)])
            u = tile[:, e1]
            tile[:, e1] = bf.add16(bf.FR, u, x)
            tile[:, e2] = bf.sub16(bf.FR, u, x)
        if inverse and p_ == len(passes) - 1:
            tile = bf.mul16(bf.FR, tile, bf.const16(
                bf.FR, pow(n, R - 2, R), "cpu"))
        out[idx] = tile
    return bf.from16(out)


@pytest.mark.parametrize("k", [2, 3, 5])
def test_ntt_pass_model_equals_the_plain_transform(k):
    """The pass kernel's model equals _ntt_plain exactly, forward and
    inverse, at log2 n 1 to 9 with passes of up to k stages (log2 n a
    multiple of k and not)."""
    rnd = random.Random(k)
    for log_n in range(1, 10):
        n = 1 << log_n
        vals = [0, 1, R - 1][:n] + [rnd.randrange(R) for _ in range(n - min(n, 3))]
        a = bf.from_int(bf.FR, vals, "cpu")
        for inverse in (False, True):
            assert torch.equal(_model_ntt(a, inverse, k),
                               fft._ntt_plain(a, inverse)), (log_n, inverse)


def test_powers_runs_cover_every_index_once():
    """bn_fr_powers' threads (j = b T L + t + r T, r < L) write each index
    below n once, at n of 0, 1, L - 1, L, L + 1 and a block's T L +- 1
    (T the block, which merlin_bn_fr_run_threads gives the wrapper)."""
    t_ = _csrc_define("BN_NTT_THREADS", "bn254_ntt.cu")
    run = _csrc_define("BN_POWERS_RUN", "bn254_ntt.cu")
    for n in (0, 1, run - 1, run, run + 1, t_ * run - 1, t_ * run,
              t_ * run + 1):
        blocks = -(-n // (t_ * run))
        seen = []
        for b in range(blocks):
            for t in range(t_):
                j0 = b * t_ * run + t
                seen += [j0 + r * t_ for r in range(run) if j0 + r * t_ < n]
        assert sorted(seen) == list(range(n)), n


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65])
def test_powers_and_poly_eval_twins_at_run_edges(n):
    """powers at n of 0, 1, L - 1, L, L + 1 (L = BN_POWERS_RUN) against
    python ints; poly_eval's twin against the host Horner, also over a
    strided slice."""
    rnd = random.Random(n)
    base, start = rnd.randrange(R), rnd.randrange(R)
    pw = bn254_cuda.powers(base, n, start=start, device="cpu")
    assert pw.shape == (n, 4)
    assert list(bf.to_int(bf.FR, pw)) == \
        [start * pow(base, i, R) % R for i in range(n)]
    coefs = [R - 1, 0, 1][:n] + [rnd.randrange(R) for _ in range(n - min(n, 3))]
    t = bf.from_int(bf.FR, coefs + coefs, "cpu")
    horner = 0
    for c in reversed(coefs):
        horner = (horner * base + c) % R
    got = bn254_cuda.poly_eval(t[:n], base)
    assert got.shape == (4,)
    assert int(bf.to_int(bf.FR, got[None])[0]) == horner
    twice = t.reshape(n, 2, 4)[:, 0] if n else t[:0]
    assert int(bf.to_int(bf.FR, bn254_cuda.poly_eval(twice, base)[None])[0]) \
        == sum(c * pow(base, i, R) for i, c in
               enumerate((coefs + coefs)[0::2][:n])) % R


# ---------------------------------------------------------------------------
# (c) kernel B3's twin: Pippenger against python-int sums
# ---------------------------------------------------------------------------


def _msm_case(F, n, seed):
    """Points k_i G with a repeated and a negated point, scalars with the
    edge values 0, 1, r - 1; returns (points, scalars, want)."""
    rnd = random.Random(seed)
    ks = [rnd.randrange(1, R) for _ in range(n)]
    ks[1] = ks[0]
    ks[2] = R - ks[0]
    es = [0, 1, R - 1, 1, 1] + [rnd.randrange(R) for _ in range(n - 5)]
    gen = curve.g1_generator("cpu") if F is F1 else curve.g2_generator("cpu")
    pts = curve.scalar_mul_table(F, gen, ks)
    total = sum(k * e for k, e in zip(ks, es)) % R
    mul, base = (pr.g1_mul, pr.G1_GEN) if F is F1 else (pr.g2_mul, pr.G2_GEN)
    return pts, scalars(es), (mul(total, base) if total else None)


def test_msm_twin_g1_matches_python_ints():
    pts, s, want = _msm_case(F1, 24, 1)
    assert one(F1, msm.msm(F1, pts, s)) == want
    # a window smaller than the reference's choice, and every digit zero
    assert one(F1, msm.msm(F1, pts, s, c=3)) == want
    assert one(F1, msm.msm(F1, pts, scalars([0] * 24))) is None


@pytest.mark.slow
def test_msm_twin_g2_matches_python_ints():
    """G2's MSM twin alone (the Groth16 tests below reach it through
    pi_b's pairing check; the card holds the kernel against it)."""
    pts, s, want = _msm_case(F2, 8, 2)
    assert one(F2, msm.msm(F2, pts, s)) == want


def _signed_recoding(e, c, bits):
    """B3's recoding of the python int e's bits below `bits`, as
    bn_msm_digits_kernel runs it: four 64-bit limbs shifted right by c a
    window, v = low c bits + carry, a negative digit and a carry where
    v > 2^(c-1)."""
    m64 = (1 << 64) - 1
    e &= (1 << bits) - 1
    s = [(e >> (64 * k)) & m64 for k in range(4)]
    half, out, carry = 1 << (c - 1), [], 0
    for _ in range(bits // c + 1):
        v = (s[0] & ((1 << c) - 1)) + carry
        s = [((s[k] >> c) | (s[k + 1] << (64 - c))) & m64 for k in range(3)] \
            + [s[3] >> c]
        carry = int(v > half)
        out.append(v - (carry << c))
    return out


def _witness_like(n, seed):
    rnd = random.Random(seed)
    return [rnd.choice([0, 1, 1, 2, rnd.randrange(1 << 20), rnd.randrange(R)])
            for _ in range(n)]


@pytest.mark.parametrize("c", [3, 12, msm.window(14_008_649)])
def test_signed_digit_entries_match_python_ints(c):
    """B3's signed-digit keys: the twin's digits equal the kernel's
    recoding read in python ints and sum back to each scalar, every digit
    in [-(2^(c-1) - 1), 2^(c-1)]; the entries (window, |digit|) in bucket
    order, the point index and the sign; none for a zero scalar or a base
    at infinity; the windows of a group alone."""
    top_carry = ((1 << 254) - 1) >> (254 % c) << (254 % c)   # top window full
    es = [0, 1, R - 1, 1 << 253, (1 << 254) - 1, top_carry,
          ((1 << c) - 1) << c, 1 << (c - 1), (1 << (c - 1)) + 1] + \
        _witness_like(23, c)
    s = scalars(es)
    half = 1 << (c - 1)
    d = msm.signed_digits_plain(s, c, 254)
    assert d.shape == (254 // c + 1, len(es))
    for i, e in enumerate(es):
        col = [int(v) for v in d[:, i]]
        assert col == _signed_recoding(e, c, 254), i
        assert sum(v << (c * w) for w, v in enumerate(col)) == e
        assert all(-half < v <= half for v in col)
    bases = msm.affine_bases(F1, curve.scalar_mul_table(
        F1, g1(), list(range(1, len(es) + 1))))
    bases[4] = -1              # x of all ones: a base at infinity
    bases[4, F1.words:] = 0
    nw = 254 // c + 1
    for w0, g in ((0, nw), (1, 2), (nw - 1, 1)):
        keys, entries = msm.digit_entries_plain(F1, bases, s, c, w0, g, 254)
        want = []
        for w in range(w0, w0 + g):
            for i, e in enumerate(es):
                v = _signed_recoding(e, c, 254)[w]
                if v and i != 4:
                    want.append(((w - w0) * half + abs(v) - 1,
                                 i | (int(v < 0) << 31)))
        want.sort(key=lambda ke: (ke[0], ke[1] & 0x7FFFFFFF))
        assert list(zip(keys.tolist(), entries.tolist())) == want
        counts = msm.digit_counts(F1, bases, s, c, w0, g, 254)
        assert counts.dtype == torch.int32 and counts.shape == (g * half,)
        assert counts.long().tolist() == torch.bincount(
            keys, minlength=g * half).tolist()
        first = torch.cumsum(counts.long(), 0) - counts.long()
        got = msm.digit_entries(F1, bases, s, c, w0, g, 254, first.int(),
                                int(counts.sum()))
        assert (got.long() & 0xFFFFFFFF).tolist() == entries.tolist()


@pytest.mark.parametrize("group", ["G1", "G2"])
def test_affine_bases_twin_matches_to_affine(group):
    """Batch-to-affine's twin against curve.to_affine: infinity, a
    repeated and a negated point, points of any Z; its words back to
    Jacobian (Z = 1) are the same points."""
    F = F1 if group == "G1" else F2
    ks = [5, 0, 7, 7, R - 5, 123456789, 0]
    gen = g1() if F is F1 else curve.g2_generator("cpu")
    pts = curve.scalar_mul_table(F, gen, ks)          # any Z
    pts = curve.add(F, pts, curve.double(F, curve.infinity(F, (len(ks),),
                                                           "cpu")))
    aff = msm.affine_bases(F, pts)
    assert aff.shape == (len(ks), 2 * F.words)
    assert torch.equal(msm.affine_bases(F, curve.pack(F, pts)), aff)
    assert torch.equal(msm.affine_bases(F, aff), aff)
    assert curve.affine_ints(F, aff) == curve.affine_ints(F, pts)
    x, y, inf = curve.to_affine(F, pts)
    assert inf.tolist() == [k == 0 for k in ks]
    fin = torch.nonzero(~inf).reshape(-1)
    assert torch.equal(aff[fin, :F.words], F.flat(x)[fin])
    assert torch.equal(aff[fin, F.words:], F.flat(y)[fin])
    assert (aff[inf, :F.words] == -1).all() and (aff[inf, F.words:] == 0).all()
    back = curve.unpack(F, msm.jacobian_words(F, aff))
    assert curve.affine_ints(F, back) == curve.affine_ints(F, pts)
    assert curve.affine_words_from_ints(F, curve.affine_ints(F, aff),
                                        "cpu").tolist() == aff.tolist()


@pytest.mark.parametrize("c", [2, 3, 4])
def test_msm_edge_bases_match_python_ints(c):
    """msm on CPU tensors (msm_plain) and the kernel route's twins
    (_msm_flow: signed digits, the counting sort's entries, strided ranges,
    affine bucket sums, the window reduce and combine) over affine bases
    with infinity, equal and opposite bases: the python-int sum."""
    rnd = random.Random(c)
    ks = [rnd.randrange(1, R) for _ in range(14)]
    ks[1] = ks[0]                  # equal bases
    ks[2] = R - ks[0]              # opposite to the first
    ks[5] = 0                      # infinity
    ks[6] = ks[3]
    es = [1, 1, 1, rnd.randrange(R), 0, rnd.randrange(R), R - 1,
          rnd.randrange(R), 2, 3] + [rnd.randrange(1 << 30) for _ in range(4)]
    aff = msm.affine_bases(F1, curve.scalar_mul_table(F1, g1(), ks))
    s = scalars(es)
    total = sum(k * e for k, e in zip(ks, es)) % R
    want = aff_mul(G, total) if total else None
    assert one(F1, msm.msm(F1, aff, s, c=c)) == want
    assert one(F1, msm._msm_flow(F1, aff, s, 254, c)) == want
    # the equal and opposite bases alone: the sum meets infinity
    assert one(F1, msm._msm_flow(F1, aff[:3], scalars([1, 1, 2]), 254, c)) \
        is None
    assert one(F1, msm._msm_flow(F1, aff[:2], scalars([1, 1]), 254, c)) == \
        aff_mul(G, 2 * ks[0] % R)
    # groups of windows: the same point
    old = msm.MSM_GROUP_ENTRIES
    try:
        msm.MSM_GROUP_ENTRIES = 3 * len(es)
        assert one(F1, msm._msm_flow(F1, aff, s, 254, c)) == want
    finally:
        msm.MSM_GROUP_ENTRIES = old


def test_bucket_ranges_cut_each_bucket():
    """bucket_ranges: every entry of every bucket in exactly one range, at
    most max_len a range, strided by the bucket's range count."""
    counts = torch.tensor([0, 1, 5, 0, 32, 33, 100, 7])
    first = torch.cumsum(counts, 0) - counts
    starts, cnt, strides, rb = msm.bucket_ranges(counts, first, 8)
    seen = {}
    for st, k, sd, b in zip(starts.tolist(), cnt.tolist(), strides.tolist(),
                            rb.tolist()):
        assert 1 <= k <= 8 and sd == -(-int(counts[b]) // 8)
        for j in range(k):
            seen.setdefault(b, []).append(st + j * sd)
    assert rb.tolist() == sorted(rb.tolist())
    for b in range(8):
        f, n = int(first[b]), int(counts[b])
        assert sorted(seen.get(b, [])) == list(range(f, f + n))


def _model_reduce(buckets, c, g, threads_max):
    """bn_msm_reduce_kernel over points stood for by ints mod r (the
    group's additions and doublings are those of Z_r): the launcher's
    threads and segments, each thread's running sums, the tree of (R, A)
    pairs; the window sums, and the last block's combine."""
    half = 1 << (c - 1)
    threads = threads_max
    while threads > 32 and threads > half:
        threads >>= 1
    s_bits = 0
    while threads << (s_bits + 1) <= half:
        s_bits += 1
    wsums = []
    for blk in range(g):
        rr, aa = [0] * threads, [0] * threads
        for t in range(threads):
            lo = t << s_bits
            if lo < half:
                run = acc = 0
                for j in range((1 << s_bits) - 1, -1, -1):
                    run = (run + buckets[blk * half + lo + j]) % R
                    acc = (acc + run) % R
                rr[t], aa[t] = run, acc
        l = 0
        while (1 << l) < threads:
            for t in range(0, threads, 2 << l):
                u = t + (1 << l)
                aa[t] = (aa[t] + aa[u] + (rr[u] << (s_bits + l))) % R
                rr[t] = (rr[t] + rr[u]) % R
            l += 1
        wsums.append(aa[0])
    acc = 0
    for w in range(g - 1, -1, -1):
        acc = ((acc << c) + wsums[w]) % R
    return wsums, acc


@pytest.mark.parametrize("c", [2, 3, 5, 7, 8, 9, 13])
def test_reduce_kernel_model_matches_the_window_sums(c):
    """The reduce kernel's segments and tree give sum_b (b + 1) B_b a
    window and the windows' combine, at windows below, at and above the
    block's threads (BN_MSM_REDUCE_THREADS); the plain twin the same."""
    rnd = random.Random(c)
    half, g = 1 << (c - 1), 3
    b = [rnd.randrange(R) if rnd.random() < 0.8 else 0 for _ in range(g * half)]
    threads = _csrc_define("BN_MSM_REDUCE_THREADS", "bn254_msm.cu")
    wsums, acc = _model_reduce(b, c, g, threads)
    want = [sum((j + 1) * b[w * half + j] for j in range(half)) % R
            for w in range(g)]
    assert wsums == want
    assert acc == sum(v << (c * w) for w, v in enumerate(want)) % R
    if c <= 5:
        pts = curve.scalar_mul_table(F1, g1(), b)
        ws = msm.window_sums_plain(F1, curve.pack(F1, pts), c)
        assert curve.affine_ints(F1, curve.unpack(F1, ws)) == \
            [aff_mul(G, v) if v else None for v in want]
        comb = msm.combine_windows_plain(F1, ws, c)
        assert one(F1, curve.unpack(F1, comb[0])) == \
            (aff_mul(G, acc) if acc else None)


# ---------------------------------------------------------------------------
# (d) the setup's batched scalars against the reference's loops
# ---------------------------------------------------------------------------


def _reference_h_scalars(tau, domain_bits, dinv):
    """The loop of the reference's setup (setup.py:97-115), as written."""
    mod = R
    n = 1 << domain_bits
    eta = fft.w_fr(domain_bits + 1)
    w = fft.w_fr(domain_bits)
    z_tau = (pow(tau, n, mod) - 1) % mod
    zc_tau = (pow(tau, n, mod) + 1) % mod
    out = []
    xk = eta
    for _ in range(n):
        lck = zc_tau * xk % mod * pow(n, mod - 2, mod) % mod
        lck = lck * pow((tau - xk) % mod, mod - 2, mod) % mod
        lck = lck * pow(pow(xk, n, mod), mod - 2, mod) % mod
        z_xk = (pow(xk, n, mod) - 1) % mod
        out.append(lck * z_tau % mod * pow(z_xk, mod - 2, mod) % mod
                   * dinv % mod)
        xk = xk * w % mod
    return out


@pytest.mark.parametrize("domain_bits", [1, 3, 6])
def test_setup_scalars_match_reference_loops(domain_bits):
    rnd = random.Random(domain_bits)
    tau, dinv = rnd.randrange(1, R), rnd.randrange(1, R)
    n = 1 << domain_bits
    assert list(bf.to_int(bf.FR, port_setup.lagrange_evals(tau, n, "cpu"))) == \
        ref_setup._lagrange_evals_at(tau, n, R)
    assert list(bf.to_int(bf.FR, port_setup.h_point_scalars(
        tau, domain_bits, dinv, "cpu"))) == \
        _reference_h_scalars(tau, domain_bits, dinv)


def test_sum_by_key_twin_matches_python_ints():
    """Sums of Fr values by key, runs longer than one range (sum_range)."""
    rnd = random.Random(9)
    keys = [rnd.randrange(5) for _ in range(600)] + [7] * 700
    vals = [rnd.randrange(R) for _ in keys]
    got = msm.sum_by_key_unsorted(None, bf.from_int(bf.FR, vals, "cpu"),
                                  torch.tensor(keys), 9)
    want = [sum(v for k, v in zip(keys, vals) if k == j) % R for j in range(9)]
    assert list(bf.to_int(bf.FR, got)) == want


def test_sum_by_key_points_twin_matches_python_ints():
    """Sums of G1 points by key (B3's buckets): a run over three ranges, so
    two passes; a repeated and a negated point; an empty key."""
    rnd = random.Random(10)
    keys = [0] * 70 + [rnd.choice([1, 3]) for _ in range(20)]
    ks = [rnd.randrange(1, R) for _ in keys]
    ks[1], ks[2] = ks[0], R - ks[3]
    pts = curve.pack(F1, curve.scalar_mul_table(F1, g1(), ks))
    order = list(range(len(keys)))
    rnd.shuffle(order)
    got = msm.sum_by_key_unsorted(F1, pts[torch.tensor(order)],
                                  torch.tensor([keys[i] for i in order]), 4)
    assert msm.sum_range(F1) < 70
    want = []
    for j in range(4):
        e = sum(k for k, key in zip(ks, keys) if key == j) % R
        want.append(aff_mul(G, e) if e else None)
    assert curve.affine_ints(F1, curve.unpack(F1, got)) == want


# ---------------------------------------------------------------------------
# (e) Groth16 on a small R1CS: the key in the exponent, the pairing, a
# tampered proof, the zkey round trip, the reference's key through convert
# ---------------------------------------------------------------------------


def small_r1cs(R1CS):
    """x * y = z, z * z = w, (x + 2) * 1 = v; publics w, v."""
    x, y = 3, 5
    z, w = x * y, (x * y) ** 2
    r1cs = R1CS(n_vars=7, n_public=2,
                a=[{3: 1}, {5: 1}, {3: 1, 0: 2}, {4: R - 1, 3: 1}],
                b=[{4: 1}, {5: 1}, {0: 1}, {0: 1}],
                c=[{5: 1}, {1: 1}, {2: 1}, {6: 1}])
    return r1cs, [1, w, x + 2, x, y, z, (x - y) % R]


@pytest.fixture(scope="module")
def small_groth16():
    r1cs, wit = small_r1cs(port_setup.R1CS)
    key, toxic = port_setup.setup(r1cs, seed=SETUP_SEED, device="cpu")
    proof = groth16.prove(key, wit, r=R_BLIND, s=S_BLIND)
    return r1cs, wit, key, toxic, proof


def test_groth16_key_in_the_exponent(small_groth16):
    r1cs, _, key, toxic, _ = small_groth16
    assert one(F1, key.vk_alpha1) == aff_mul(G, toxic["alpha"])
    assert one(F1, key.vk_delta1) == aff_mul(G, toxic["delta"])
    assert one(F2, key.vk_beta2) == pr.g2_mul(toxic["beta"], pr.G2_GEN)
    assert curve.affine_ints(F1, key.points_a) == \
        [aff_mul(G, u) if u else None for u in toxic["u"]]
    assert curve.affine_ints(F2, key.points_b2) == \
        [pr.g2_mul(v, pr.G2_GEN) if v else None for v in toxic["v"]]
    n = 1 << key.domain_bits
    hs = _reference_h_scalars(toxic["tau"], key.domain_bits,
                              pow(toxic["delta"], R - 2, R))
    assert curve.affine_ints(F1, key.points_h) == [aff_mul(G, h) for h in hs]
    assert len(key.coefs) == sum(len(x) for x in r1cs.a + r1cs.b)
    assert n == 4


def test_setup_pieces_split_the_setup_and_leave_the_key(small_groth16):
    """setup(timer=...) records its six pieces in order and makes the same
    key as setup without one."""
    r1cs, _, key, _, _ = small_groth16
    pieces = TimerLog("setup", quiet=True)
    timed, _ = port_setup.setup(r1cs, seed=SETUP_SEED, device="cpu",
                                timer=pieces)
    assert [k for k, _ in pieces.spans] == [
        "SETUP_LAGRANGE", "SETUP_COLUMNS", "SETUP_SUMS", "SETUP_COEFS",
        "SETUP_SCALARS", "SETUP_POINTS"]
    for name in ("vk_alpha1", "vk_delta1"):
        assert torch.equal(curve.pack(F1, getattr(timed, name)),
                           curve.pack(F1, getattr(key, name))), name
    assert torch.equal(curve.pack(F2, timed.vk_beta2),
                       curve.pack(F2, key.vk_beta2))
    for name in ("points_a", "points_b1", "points_b2", "points_c", "points_h"):
        assert torch.equal(getattr(timed, name), getattr(key, name)), name
    assert timed.coefs.as_list() == key.coefs.as_list()


def test_groth16_proof_passes_the_pairing_and_a_tampered_one_fails(
        small_groth16):
    r1cs, wit, _, toxic, proof = small_groth16
    vk = pr.make_vk(toxic, r1cs.n_public)
    assert proof["publics"] == wit[1:3]
    assert pr.groth16_verify(vk, proof)
    bad = dict(proof)
    bad["pi_a"] = [int(proof["pi_a"][0]) + 1, int(proof["pi_a"][1])]
    assert pr.groth16_verify(vk, bad) is False
    bad = dict(proof, publics=[wit[1] + 1, wit[2]])
    assert pr.groth16_verify(vk, bad) is False


def test_groth16_equals_the_reference_in_the_exponent(small_groth16):
    """The port's key and proof (CPU twins) are the reference setup's and
    prover's: the same seed's toxic waste, and every proof and key point
    equal to its exponent computed with the JAX package's host python."""
    r1cs, wit, key, toxic, proof = small_groth16
    ref_toxic, doc = groth16_in_the_exponent(r1cs, wit, SETUP_SEED, R_BLIND,
                                             S_BLIND)
    assert {k: toxic[k] for k in ("tau", "alpha", "beta", "delta")} == \
        {k: ref_toxic[k] for k in ("tau", "alpha", "beta", "delta")}
    assert list(toxic["u"]) == ref_toxic["u"]
    for k in ("pi_a", "pi_b", "pi_c", "publics"):
        assert proof[k] == doc["proof"][k], k
    assert [list(p) for p in [one(F1, key.vk_alpha1)]] == [doc["vk"]["alpha1"]]
    assert json.loads(json.dumps(one(F2, key.vk_delta2))) == \
        doc["vk"]["delta2"]


def test_build_abc_matches_reference_loop(small_groth16):
    _, wit, key, _, _ = small_groth16
    n = 1 << key.domain_bits
    pol_a, pol_b = [0] * n, [0] * n
    for (m, c, s, v) in key.coefs.as_list():
        pol = pol_a if m == 0 else pol_b
        pol[c] = (pol[c] + v * wit[s]) % R
    got_a, got_b = groth16.build_abc(key, wit)
    assert list(bf.to_int(bf.FR, got_a)) == pol_a
    assert list(bf.to_int(bf.FR, got_b)) == pol_b


@pytest.mark.slow
def test_zkey_round_trip_and_reference_key_through_convert(small_groth16):
    """The port's key -> zkey bytes -> the reference's key_from_zkey ->
    convert: the same limbs as the port's own key_from_zkey, and the same
    coefficient table; the converted key proves the same proof."""
    r1cs, wit, key, toxic, proof = small_groth16
    zk = groth16.key_to_zkey(key)
    raw = binfile.write_zkey(zk)
    assert raw == ref_binfile.write_zkey(ref_binfile.load_zkey(raw))
    ref_key = ref_groth16.key_from_zkey(ref_binfile.load_zkey(raw))
    assert ref_key.coefs == key.coefs.as_list()
    ref_np = type(ref_key)(**{
        k: (None if v is None else
            jax_tree_to_numpy(v) if k.startswith(("vk_", "points_")) else v)
        for k, v in vars(ref_key).items()})
    port_key = convert.groth16_key_from_reference(ref_np, "cpu")
    own = groth16.key_from_zkey(zk, "cpu")
    for name in ("vk_alpha1", "vk_beta1", "vk_delta1"):
        assert torch.equal(curve.pack(F1, getattr(port_key, name)),
                           curve.pack(F1, getattr(own, name))), name
    for name in ("vk_beta2", "vk_delta2"):
        assert torch.equal(curve.pack(F2, getattr(port_key, name)),
                           curve.pack(F2, getattr(own, name))), name
    for name in ("points_a", "points_b1", "points_b2", "points_c", "points_h"):
        assert torch.equal(getattr(port_key, name), getattr(own, name)), name
    assert own.coefs.as_list() == key.coefs.as_list()
    assert groth16.prove(port_key, wit, r=R_BLIND, s=S_BLIND) == proof


@pytest.mark.slow
def test_groth16_equals_the_reference_setup_and_prove(small_groth16):
    """The JAX package's own setup() and prove() on the small R1CS (its
    jitted MSM, FFT and tables on the CPU, minutes of XLA): the same toxic
    waste and coefficient table, every key point and the proof equal the
    port's, affine; and groth16_in_the_exponent, which writes the golden
    file, gives the reference prover's proof."""
    r1cs, wit, key, toxic, proof = small_groth16
    ref_r1cs, _ = small_r1cs(ref_setup.R1CS)
    ref_key, ref_toxic = ref_setup.setup(ref_r1cs, seed=SETUP_SEED)
    for k in ("tau", "alpha", "beta", "delta"):
        assert int(ref_toxic[k]) == toxic[k], k
    for k in ("u", "v", "w"):
        assert [int(x) for x in ref_toxic[k]] == list(toxic[k]), k
    assert ref_key.coefs == key.coefs.as_list()
    ref_np = type(ref_key)(**{
        k: (None if v is None else
            jax_tree_to_numpy(v) if k.startswith(("vk_", "points_")) else v)
        for k, v in vars(ref_key).items()})
    ref_port = convert.groth16_key_from_reference(ref_np, "cpu")
    for name in ("vk_alpha1", "vk_beta1", "vk_delta1", "vk_beta2",
                 "vk_delta2", "points_a", "points_b1", "points_b2",
                 "points_c", "points_h"):
        F = F2 if name in ("vk_beta2", "vk_delta2", "points_b2") else F1
        got, want = getattr(key, name), getattr(ref_port, name)
        if name.startswith("vk_"):
            assert one(F, got) == one(F, want), name
        else:
            assert curve.affine_ints(F, got) == curve.affine_ints(F, want), name
    ref_proof = ref_groth16.prove(ref_key, wit, r=R_BLIND, s=S_BLIND)
    _, doc = groth16_in_the_exponent(r1cs, wit, SETUP_SEED, R_BLIND, S_BLIND)
    for k in ("pi_a", "pi_b", "pi_c", "publics"):
        ref_k = json.loads(json.dumps(ref_proof[k], default=int))
        assert proof[k] == ref_k, k
        assert doc["proof"][k] == ref_k, k


def jax_tree_to_numpy(p):
    import jax

    return jax.tree_util.tree_map(np.asarray, p)


def test_final_stage_refuses_fflonk(monkeypatch):
    """FinalStage(protocol="fflonk") is ported (tests/test_torch_fflonk.py
    proves through it); what it refuses is a PLONK form whose 4n domain
    exceeds Fr's two-adicity (the production final R1CS counts n = 2^27),
    with a ValueError before the PLONK build and the setup."""
    from merlin_zkevm_prover_tpu_torch.snark import r1cs_to_plonk as prt

    stage = FinalStage(None, 0, protocol="fflonk", device="cpu")
    assert stage.protocol == "fflonk" and stage.key is None

    def never(*_a, **_k):
        raise AssertionError("built past the domain check")

    big = port_setup.R1CS(n_vars=1, n_public=0, a=[], b=[], c=[])
    monkeypatch.setattr(prt, "constraint_gates",
                        lambda r1cs: np.array([(1 << 26) + 1]))
    monkeypatch.setattr(prt, "r1cs_to_plonk", never)
    with pytest.raises(ValueError, match="two-adicity"):
        stage._prove_fflonk(big, [1])
    assert stage.key is None and stage.stats["plonk_n"] == 1 << 27


# ---------------------------------------------------------------------------
# (f) the final R1CS of the golden recursiveF proof, in both packages; the
# golden Groth16 proof on the card
# ---------------------------------------------------------------------------


def _bn128_golden():
    with open(BN128_GOLDEN) as f:
        return json.load(f)


def test_build_final_r1cs_equals_reference():
    g = _bn128_golden()
    air, _ = build_smoke_air(n_bits=g["n_bits"], seed=g["seed"])
    info = compile_air(air, **BN128_SETTINGS)
    r1cs, wit = fc.build_final_r1cs(info, g["const_root"][0],
                                    StarkProof.from_json(json.dumps(g["proof"])))
    ref_air, _ = ref_smoke(n_bits=g["n_bits"], seed=g["seed"])
    ref_r1cs, ref_wit = ref_fc.build_final_r1cs(
        ref_compile(ref_air, **BN128_SETTINGS), g["const_root"][0],
        RefProof.from_json(json.dumps(g["proof"])))
    assert wit == ref_wit
    assert (r1cs.n_vars, r1cs.n_public) == (ref_r1cs.n_vars, ref_r1cs.n_public)
    assert r1cs.a == ref_r1cs.a and r1cs.b == ref_r1cs.b and r1cs.c == ref_r1cs.c
    with open(GROTH16_GOLDEN) as f:
        doc = json.load(f)
    assert (len(r1cs.a), r1cs.n_vars) == (doc["n_constraints"], doc["n_vars"])
