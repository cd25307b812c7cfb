"""The port's fflonk (snark/fflonk.py, snark/r1cs_to_plonk.py,
utils/keccak.py, FinalStage(protocol="fflonk")) against the JAX package's.

Tolerance: none.  Every value is a BN254 field element or curve point,
compared as python ints.

The JAX fflonk is python ints throughout: one setup at n = 8 takes some
15 s on the CPU (9n + 32 scalar multiplications of 84 ms), so its proofs
are golden files that the JAX package writes:

    MERLIN_WRITE_GOLDEN=1 python tests/test_torch_fflonk.py

``torch_fflonk_n8.json``: tests/test_fflonk.py's ``_mul_circuit(15, 3, 5)``
with its first n - 2 values per wire, ``seed=7``, ``rand=b"\\x01" * 32``.
``torch_fflonk_plonk.json``: ``r1cs_to_plonk`` over the seeded R1CS of
``seeded_r1cs()`` (every branch of the conversion: a single scaled term,
chains with a constant, constant A, B or C sides, a constant-by-constant
row, an all-constant row, an empty C side, public rows), proven from the
``[:n - 2]`` wire lists.  Each file holds the key's C0, x2 and w, the head
and tail of c0_coefs, and the whole proof.
"""

import json
import os
import random
import sys
import time

import pytest
import torch

# the suite runs several workers side by side: one thread each
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
N8_GOLDEN = os.path.join(DATA, "torch_fflonk_n8.json")
PLONK_GOLDEN = os.path.join(DATA, "torch_fflonk_plonk.json")
BN128_GOLDEN = os.path.join(DATA, "torch_bn128_proof.json")
FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617
N8_SEED, N8_RAND = 7, b"\x01" * 32
PLONK_SEED, PLONK_RAND = 11, b"\x05" * 32
EDGE = 8   # c0_coefs kept from each end


def mul_circuit(pub_product: int, x: int, y: int):
    """tests/test_fflonk.py's n = 8 circuit (row 0 exposes the public
    product, row 1 enforces a*b - c = 0, sigma wires c1 to a0), as lists;
    the wires cut to their first n - 2 values."""
    n = 8
    q = {k: [0] * n for k in ("qL", "qR", "qM", "qO", "qC")}
    q["qL"][0] = 1
    q["qM"][1] = 1
    q["qO"][1] = FR - 1
    sigma = list(range(3 * n))
    sigma[0], sigma[2 * n + 1] = sigma[2 * n + 1], sigma[0]
    a = [pub_product, x] + [0] * (n - 4)
    b = [0, y] + [0] * (n - 4)
    c = [0, pub_product] + [0] * (n - 4)
    return dict(n=n, sigma=sigma, n_public=1, **q), a, b, c


def seeded_r1cs(seed: int = 3):
    """A satisfied R1CS of 22 constraints reaching every branch of
    r1cs_to_plonk: (n_vars, n_public, a, b, c, witness)."""
    rng = random.Random(seed)
    wit = [1, 0, 0] + [rng.randrange(1, FR) for _ in range(6)]
    zero_sig = len(wit)
    wit.append(0)
    inv_sig = len(wit)
    wit.append(pow(wit[3], FR - 2, FR))
    rows = []

    def val(lc):
        return sum(k * wit[s] for s, k in lc.items()) % FR

    def new(a, b, ck=1, c0=0):
        """A constraint a * b = ck * out + c0 with a fresh out."""
        v = (val(a) * val(b) - c0) * pow(ck, FR - 2, FR) % FR
        wit.append(v)
        c = {len(wit) - 1: ck}
        if c0:
            c[0] = c0
        rows.append((a, b, c))
        return len(wit) - 1

    def pick():
        return rng.randrange(3, len(wit))

    # the publics: s * t and s * t - 5
    rows.append(({3: 1}, {4: 1}, {1: 1}))
    wit[1] = wit[3] * wit[4] % FR
    rows.append(({3: 1}, {4: 1}, {2: 1, 0: 5}))
    wit[2] = (wit[3] * wit[4] - 5) % FR
    for i in range(4):
        new({pick(): rng.randrange(2, FR)}, {pick(): 1})                # scaled
        new({pick(): rng.randrange(2, FR), pick(): 1, 1: 3,
             0: rng.randrange(1, FR)}, {pick(): 1})                     # chain + const
        new({0: rng.randrange(2, 100)}, {pick(): 1, pick(): 7})         # constant A
        new({pick(): 1}, {0: 9}, ck=rng.randrange(2, FR), c0=4)         # constant B, scaled C
    new({0: 2}, {0: 3})                                                 # constant x constant
    rows.append(({0: 2}, {0: 3}, {0: 6}))                               # all constant
    rows.append(({3: 1}, {inv_sig: 1}, {0: 1}))                         # constant C
    rows.append(({pick(): 1}, {zero_sig: 1}, {}))                       # empty C
    for a, b, c in rows:
        assert val(a) * val(b) % FR == val(c), (a, b, c)
    return len(wit), 2, [r[0] for r in rows], [r[1] for r in rows], \
        [r[2] for r in rows], wit


def _jsonable(proof):
    out = {k: proof[k] for k in ("C1", "C2", "W1", "W2", "publics")}
    out["evals"] = dict(proof["evals"])
    return json.loads(json.dumps(out))


def _key_doc(key):
    c0 = list(key.c0_coefs)
    return {"C0": key.C0, "x2": key.x2, "w": key.w, "c0_len": len(c0),
            "c0_head": c0[:EDGE], "c0_tail": c0[-EDGE:]}


def write_golden() -> None:
    """Prove both circuits with the JAX package on the CPU and save them."""
    if os.environ.get("MERLIN_WRITE_GOLDEN") != "1":
        raise RuntimeError("set MERLIN_WRITE_GOLDEN=1 to run the JAX prover")
    import tests.conftest  # noqa: F401  (JAX on the CPU, x64 on)
    from merlin_zkevm_prover_tpu.snark import fflonk as jf
    from merlin_zkevm_prover_tpu.snark.r1cs_to_plonk import r1cs_to_plonk
    from merlin_zkevm_prover_tpu.snark.setup import R1CS

    t0 = time.time()
    cs, a, b, c = mul_circuit(15, 3, 5)
    key = jf.fflonk_setup(jf.PlonkCS(**cs), seed=N8_SEED)
    proof = jf.fflonk_prove(key, a, b, c, rand=N8_RAND)
    assert jf.fflonk_verify(key, proof)
    doc = {"writer": "merlin_zkevm_prover_tpu.snark.fflonk (JAX package, "
                     "CPU)", "seed": N8_SEED, "rand": N8_RAND.hex(),
           "circuit": {"cs": cs, "a": a, "b": b, "c": c},
           "key": _key_doc(key), "proof": _jsonable(proof),
           "seconds": time.time() - t0}
    with open(N8_GOLDEN, "w") as f:
        json.dump(doc, f, separators=(",", ":"))
    print(f"n8: {doc['seconds']:.1f} s", flush=True)

    t0 = time.time()
    n_vars, n_public, ra, rb, rc, wit = seeded_r1cs()
    r1cs = R1CS(n_vars=n_vars, n_public=n_public, a=ra, b=rb, c=rc)
    cs, av, bv, cv = r1cs_to_plonk(r1cs, wit)
    n = cs.n
    key = jf.fflonk_setup(cs, seed=PLONK_SEED)
    proof = jf.fflonk_prove(key, av[:n - 2], bv[:n - 2], cv[:n - 2],
                            rand=PLONK_RAND)
    assert jf.fflonk_verify(key, proof)
    doc = {"writer": "merlin_zkevm_prover_tpu.snark.r1cs_to_plonk + fflonk "
                     "(JAX package, CPU)", "n": n, "seed": PLONK_SEED,
           "rand": PLONK_RAND.hex(),
           "r1cs": {"n_vars": n_vars, "n_public": n_public,
                    **{m: [sorted(d.items()) for d in rows]
                       for m, rows in (("a", ra), ("b", rb), ("c", rc))}},
           "witness": wit, "key": _key_doc(key),
           "proof": _jsonable(proof), "seconds": time.time() - t0}
    with open(PLONK_GOLDEN, "w") as f:
        json.dump(doc, f, separators=(",", ":"))
    print(f"plonk: n = {n}, {doc['seconds']:.1f} s", flush=True)


if __name__ == "__main__":
    write_golden()
    sys.exit(0)


import merlin_zkevm_prover_tpu.snark.fflonk as jf  # noqa: E402
import merlin_zkevm_prover_tpu.snark.r1cs_to_plonk as jrt  # noqa: E402
from merlin_zkevm_prover_tpu.snark.setup import R1CS as JaxR1CS  # noqa: E402
from merlin_zkevm_prover_tpu.utils.keccak import keccak256 as jax_keccak  # noqa: E402

from merlin_zkevm_prover_tpu_torch import convert  # noqa: E402
from merlin_zkevm_prover_tpu_torch.ops import bn254_cuda  # noqa: E402
from merlin_zkevm_prover_tpu_torch.ops import bn254_fflonk_cuda as ffk  # noqa: E402
from merlin_zkevm_prover_tpu_torch.ops import bn254_field as bf  # noqa: E402
from merlin_zkevm_prover_tpu_torch.recursion.final import FinalStage  # noqa: E402
from merlin_zkevm_prover_tpu_torch.snark import fflonk as pf  # noqa: E402
from merlin_zkevm_prover_tpu_torch.snark import r1cs_to_plonk as prt  # noqa: E402
from merlin_zkevm_prover_tpu_torch.snark.pairing import G1_GEN, g1_add  # noqa: E402
from merlin_zkevm_prover_tpu_torch.snark.setup import R1CS  # noqa: E402
from merlin_zkevm_prover_tpu_torch.utils.keccak import keccak256  # noqa: E402

CPU = torch.device("cpu")


def _t(vals):
    return pf.fr_tensor(vals, CPU)


def _ints(t):
    return pf.fr_ints(t)


def _golden(path):
    with open(path) as f:
        return json.load(f)


def _same_key(key, doc):
    c0 = _ints(key.c0_coefs)
    got = {"C0": key.C0, "x2": key.x2, "w": key.w, "c0_len": len(c0),
           "c0_head": c0[:EDGE], "c0_tail": c0[-EDGE:]}
    assert json.loads(json.dumps(got)) == doc


def _jax_key(key):
    """The port's key as the JAX package's FflonkKey (no JAX setup)."""
    fields = convert.fflonk_key_to_reference(key)
    fields["cs"] = jf.PlonkCS(**fields["cs"])
    return jf.FflonkKey(**fields)


def _tampered(proof):
    p = convert.fflonk_proof_to_reference(proof)
    bad_eval = dict(p, evals=dict(p["evals"], a=(p["evals"]["a"] + 1) % FR))
    bad_pub = dict(p, publics=[(p["publics"][0] + 1) % FR] + p["publics"][1:])
    bad_w1 = dict(p, W1=g1_add(p["W1"], G1_GEN))
    return {"eval": bad_eval, "public": bad_pub, "W1": bad_w1}


# ---------------------------------------------------------------------------
# utils/keccak.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("length", [0, 135, 136, 137, 1000])
def test_keccak256_matches_reference(length):
    data = bytes(random.Random(length).randrange(256) for _ in range(length))
    assert keccak256(data) == jax_keccak(data)
    if length == 0:
        assert keccak256(b"").hex() == ("c5d2460186f7233c927e7db2dcc703c0"
                                        "e500b653ca82273b7bfad8045d85a470")


# ---------------------------------------------------------------------------
# F1-F3's plain twins against python-int oracles
# ---------------------------------------------------------------------------


def _scan_oracle(vals, k, op, backward):
    out = list(vals)
    for c in range(k):
        idx = list(range(c, len(vals), k))
        if backward:
            idx.reverse()
        acc = 1 if op == "mul" else 0
        for i in idx:
            acc = acc * vals[i] % FR if op == "mul" else (acc + vals[i]) % FR
            out[i] = acc
    return out


@pytest.mark.parametrize("length,k", [(1, 1), (37, 1), (64, 3), (67, 4),
                                      (65, 8), (96, 32), (40, 40), (256, 64)])
@pytest.mark.parametrize("op", ["add", "mul"])
@pytest.mark.parametrize("backward", [False, True])
def test_scan_twin(length, k, op, backward):
    rng = random.Random(length * 131 + k)
    vals = [rng.choice([0, 1, FR - 1, rng.randrange(FR)]) for _ in range(length)]
    got = _ints(ffk.scan(_t(vals), k, op, backward))
    assert got == _scan_oracle(vals, k, op, backward)


def test_scan_in_place_and_rejects():
    vals = list(range(1, 30))
    x = _t(vals)
    out = ffk.scan(x, 3, "add", out=x)
    assert out is x and _ints(x) == _scan_oracle(vals, 3, "add", False)
    with pytest.raises(ValueError):
        ffk.scan(x, 3, "sub")
    with pytest.raises(TypeError):
        ffk.scan(x[:, :2], 3)


def test_inv_twin():
    vals = [1, 2, FR - 1, 0, 12345, FR - 2]
    got = _ints(ffk.inv(_t(vals)))
    assert got == [pow(v, FR - 2, FR) for v in vals]


def _csrc_define(name):
    """The value of a ``#define`` of csrc/bn254_fflonk.cu."""
    import re

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "merlin_zkevm_prover_tpu_torch", "csrc", "bn254_fflonk.cu")
    with open(path) as f:
        return int(re.search(rf"^#define {name} (\d+)", f.read(), re.M).group(1))


def test_fflonk_geometry_matches_source():
    """The wrapper's geometry constants are the kernels' #defines; F2's
    product tree needs a power-of-two block."""
    assert (ffk.INV_THREADS, ffk.INV_RUN, ffk.QUOTIENT_THREADS,
            ffk.QUOTIENT_RUN, ffk.TWO_ADICITY) == tuple(_csrc_define(k) for k in (
                "BN_INV_THREADS", "BN_INV_RUN", "BN_FFLONK_THREADS",
                "BN_QUOTIENT_RUN", "BN_FR_TWO_ADICITY"))
    assert ffk.INV_THREADS & (ffk.INV_THREADS - 1) == 0


def _inv_edge_vals(n, per, threads, run, seed):
    """n values with zeros at the first and last slot of some threads' runs
    and of every block, a block of zeros only (the second, when there are
    three), 1 and r - 1."""
    rng = random.Random(seed)
    vals = [rng.choice([1, FR - 1, rng.randrange(1, FR)]) for _ in range(n)]
    nb = -(-n // per)
    for b in range(nb):
        for t in (0, 1, threads - 1):
            for r in (0, run - 1):
                if b * per + t + r * threads < n:
                    vals[b * per + t + r * threads] = 0
    if nb >= 3:
        vals[per:2 * per] = [0] * per
    return vals


@pytest.mark.parametrize("n", [1, 255, 257, 1000])
def test_inv_twin_matches_reference(n):
    """F2's twin at zeros and at the block edges' sizes against the JAX
    package's ``_inv``."""
    vals = _inv_edge_vals(n, 64, 16, 4, n)
    assert _ints(ffk.inv(_t(vals))) == [jf._inv(v) for v in vals]


def _binary_inv(x):
    """A python-int transcription of fr_inv_binary's loop: 1 / x mod r by
    the binary extended Euclidean algorithm (x in [1, r))."""
    u, v, x1, x2 = x, FR, 1, 0
    while u != 1 and v != 1:
        while u % 2 == 0:
            u //= 2
            x1 = (x1 if x1 % 2 == 0 else x1 + FR) // 2
        while v % 2 == 0:
            v //= 2
            x2 = (x2 if x2 % 2 == 0 else x2 + FR) // 2
        if u >= v:
            u, x1 = u - v, (x1 - x2) % FR
        else:
            v, x2 = v - u, (x2 - x1) % FR
    return x1 if u == 1 else x2


@pytest.mark.parametrize("x", [1, 2, 3, FR - 1, FR - 2, 1 << 64, (1 << 253) % FR,
                               0x30644E72E131A029B85045B68181585D, 12345678910])
def test_binary_inverse_model(x):
    """fr_inv_binary on a Montgomery word X = x R: the loop gives 1 / X,
    two Montgomery products by R^2 give R / x, Montgomery's 1 / x."""
    R = pow(2, 256, FR)
    X = x * R % FR
    mont = lambda a, b: a * b * pow(R, -1, FR) % FR    # noqa: E731
    assert _binary_inv(X) * X % FR == 1
    assert mont(mont(_binary_inv(X), R * R % FR), R * R % FR) == \
        pow(x, FR - 2, FR) * R % FR


def _model_inv(vals, threads, run):
    """A python-int transcription of csrc/bn254_fflonk.cu's
    bn_fr_inv_kernel: blocks of threads x run elements, thread t's run t,
    t + T, ...; prefix products (a zero or a slot past n as one), the
    threads' totals up a product tree (node k's children 2k, 2k + 1), one
    inversion of the root (fr_inv_binary), the inverses down the tree, the
    run walked backwards."""
    n, per = len(vals), threads * run
    out = [None] * n
    for blk in range(-(-n // per)):
        pre, tree = {}, [None] * (2 * threads)
        for t in range(threads):
            acc = 1
            for r in range(run):
                e = blk * per + t + r * threads
                if e < n and vals[e]:
                    acc = acc * vals[e] % FR
                pre[t, r] = acc
            tree[threads + t] = acc
        s = threads // 2
        while s >= 1:
            for k in range(s, 2 * s):
                tree[k] = tree[2 * k] * tree[2 * k + 1] % FR
            s //= 2
        tree[1] = _binary_inv(tree[1])
        s = 1
        while s < threads:
            for k in range(s, 2 * s):
                inv, left, right = tree[k], tree[2 * k], tree[2 * k + 1]
                tree[2 * k], tree[2 * k + 1] = inv * right % FR, inv * left % FR
            s *= 2
        for t in range(threads):
            acc = tree[threads + t]
            for r in range(run - 1, -1, -1):
                e = blk * per + t + r * threads
                if e >= n:
                    continue
                if vals[e] == 0:
                    out[e] = 0
                    continue
                out[e] = acc * pre[t, r - 1] % FR if r else acc
                acc = acc * vals[e] % FR
    return out


@pytest.mark.parametrize("threads,run,n", [(4, 2, 1), (4, 2, 29), (8, 3, 24),
                                           (8, 3, 73), (2, 1, 9), (1, 4, 10),
                                           (256, 8, 2 * 2048 + 5)])
def test_inv_kernel_model(threads, run, n):
    """The batch inverse's schedule gives every inverse (0 for 0) at ragged
    ends, zero slots and a block of zeros; the last case at the source's
    geometry."""
    if threads == 256:
        threads, run = ffk.INV_THREADS, ffk.INV_RUN
    vals = _inv_edge_vals(n, threads * run, threads, run, n + threads)
    assert _model_inv(vals, threads, run) == [pow(v, FR - 2, FR) for v in vals]


@pytest.mark.parametrize("n", [8, 32, 64])
@pytest.mark.parametrize("threads,run", [(4, 2), (2, 3), (16, 1),
                                         (ffk.QUOTIENT_THREADS, ffk.QUOTIENT_RUN)])
def test_power_runs_match_pow(n, threads, run):
    """F3's schedule of X: each thread's first power from the root's
    squarings, then one product by root^threads a point."""
    root = jf._find_w(n)
    got = _ints(bf.from16(ffk.power_runs_plain(root, n, threads, run, CPU)))
    assert got == [pow(root, i, FR) for i in range(n)]


def _quotient_oracle(cols, root, beta, gamma, shift):
    n = len(cols["a"])
    t0, num, den, t1, t2 = [], [], [], [], []
    for i in range(n):
        a, b, c = cols["a"][i], cols["b"][i], cols["c"][i]
        t0.append((a * cols["ql"][i] + b * cols["qr"][i]
                   + a * b % FR * cols["qm"][i] + c * cols["qo"][i]
                   + cols["qc"][i] + cols["pi"][i]) % FR)
        bx = beta * pow(root, i, FR) % FR
        e1 = ((a + bx + gamma) * (b + 2 * bx + gamma) % FR
              * (c + 3 * bx + gamma)) % FR
        e2 = ((a + beta * cols["s1"][i] + gamma)
              * (b + beta * cols["s2"][i] + gamma) % FR
              * (c + beta * cols["s3"][i] + gamma)) % FR
        num.append(e1)
        den.append(e2)
        z, zw = cols["z"][i], cols["z"][(i + shift) % n]
        t1.append((z - 1) * cols["l1"][i] % FR)
        t2.append((e1 * z - e2 * zw) % FR)
    return t0, num, den, t1, t2


@pytest.mark.parametrize("n", [8, 32, 64])
def test_quotient_twin(n):
    rng = random.Random(n)
    cols = {k: [rng.choice([0, 1, FR - 1, rng.randrange(FR)]) for _ in range(n)]
            for k in ffk.QUOTIENT_COLUMNS}
    root = jf._find_w(n)
    beta, gamma = rng.randrange(FR), rng.randrange(FR)
    want = _quotient_oracle(cols, root, beta, gamma, 4)
    tc = {k: _t(v) for k, v in cols.items()}
    (t0,) = ffk.quotient(0, tc)
    num, den = ffk.quotient(1, tc, root=root, beta=beta, gamma=gamma)
    t1, t2 = ffk.quotient(2, tc, root=root, beta=beta, gamma=gamma, shift=4)
    assert [_ints(x) for x in (t0, num, den, t1, t2)] == list(want)
    rows = torch.tensor([0, n - 1, 3])
    part2 = ffk.quotient_plain(2, tc, root, beta, gamma, 4, rows=rows)
    assert [_ints(x) for x in part2] == [[w[i] for i in (0, n - 1, 3)]
                                         for w in want[3:]]
    with pytest.raises(ValueError):
        ffk.quotient(2, {k: tc[k] for k in ("a", "b", "c")})


@pytest.mark.parametrize("n", [8, 32, 64])
def test_quotient_strided_sigmas(n):
    """Part 1 with s1..s3 every fourth row of 4n evaluations (the prover's
    views, read in place) against the python-int oracle."""
    rng = random.Random(n + 1)
    cols = {k: [rng.choice([0, 1, FR - 1, rng.randrange(FR)]) for _ in range(n)]
            for k in ffk.PART_COLUMNS[1]}
    big = {k: [rng.randrange(FR) for _ in range(4 * n)] for k in ("s1", "s2", "s3")}
    for k in big:
        cols[k] = big[k][::4]
    root, beta, gamma = jf._find_w(n), rng.randrange(FR), rng.randrange(FR)
    full = dict(cols, **{k: [0] * n for k in ffk.QUOTIENT_COLUMNS
                         if k not in cols})
    want = _quotient_oracle(full, root, beta, gamma, 0)
    tc = {k: _t(cols[k]) for k in ("a", "b", "c")}
    tc.update({k: _t(big[k])[::4] for k in big})
    assert ffk._s_stride(tc, 1) == 4
    num, den = ffk.quotient(1, tc, root=root, beta=beta, gamma=gamma)
    assert [_ints(num), _ints(den)] == [want[1], want[2]]


# ---------------------------------------------------------------------------
# the polynomial layer against the JAX functions
# ---------------------------------------------------------------------------


def test_polys_match_reference():
    rng = random.Random(9)
    for n in (1, 2, 8, 32):
        ev = [rng.randrange(FR) for _ in range(n)]
        coefs = jf.poly_from_evals(ev)
        assert _ints(pf.poly_from_evals(_t(ev))) == coefs
        assert _ints(pf.poly_extend_evals(_t(coefs), 4 * n)) == \
            jf.poly_extend_evals(coefs, 4 * n)
        x = rng.randrange(FR)
        assert pf.poly_eval(_t(coefs), x) == jf.poly_eval(coefs, x)
        assert pf.poly_eval(coefs, x) == jf.poly_eval(coefs, x)
    a = [rng.randrange(FR) for _ in range(13)]
    b = [rng.randrange(FR) for _ in range(7)] + [0]
    assert _ints(pf.poly_add(_t(a), _t(b))) == jf.poly_add(a, b)
    assert _ints(pf.poly_sub(_t(b), _t(a))) == jf.poly_sub(b, a)
    assert _ints(pf.poly_mul_scalar(_t(a), 5)) == jf.poly_mul_scalar(a, 5)
    assert _ints(pf._combine([_t(a), _t(b), _t([])], 3, 13)) == \
        jf._combine([a, b, []], 3, 13)
    assert pf.poly_zerofier([3, 4]) == jf.poly_zerofier([3, 4])
    assert pf.lagrange_interp([1, 2, 5], a[:3]) == \
        jf.lagrange_interp([1, 2, 5], a[:3])


@pytest.mark.parametrize("k,beta", [(1, 7), (3, None), (4, 1), (8, None),
                                    (16, 1)])
def test_div_zerofier_matches_reference(k, beta):
    rng = random.Random(k)
    beta = rng.randrange(2, FR) if beta is None else beta
    q = [rng.randrange(FR) for _ in range(29)]
    # p = q (X^k - beta), exact
    p = [0] * (len(q) + k)
    for i, c in enumerate(q):
        p[i + k] = (p[i + k] + c) % FR
        p[i] = (p[i] - beta * c) % FR
    assert _ints(pf.poly_div_zerofier(_t(p), k, beta)) == \
        jf.poly_div_zerofier(p, k, beta)
    bad = list(p)
    bad[0] = (bad[0] + 1) % FR
    with pytest.raises(ValueError, match="non-zero remainder"):
        jf.poly_div_zerofier(bad, k, beta)
    with pytest.raises(ValueError, match="non-zero remainder"):
        pf.poly_div_zerofier(_t(bad), k, beta)
    # shorter than the divisor: empty, or the remainder check
    assert _ints(pf.poly_div_zerofier(_t([0] * k), k, beta)) == []
    with pytest.raises(ValueError):
        pf.poly_div_zerofier(_t([1]), k + 1, beta)


def test_domain_limit_names_two_adicity():
    pf.check_domain(1 << 26)
    with pytest.raises(ValueError, match="two-adicity"):
        pf.check_domain(1 << 27)
    with pytest.raises(ValueError, match="two-adicity"):
        pf._find_w(1 << 29)


# ---------------------------------------------------------------------------
# golden proofs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def proven_n8():
    cs, a, b, c = mul_circuit(15, 3, 5)
    key = pf.fflonk_setup(pf.PlonkCS(**cs), seed=N8_SEED, device="cpu")
    return key, pf.fflonk_prove(key, a, b, c, rand=N8_RAND)


def test_n8_equals_golden(proven_n8):
    key, proof = proven_n8
    doc = _golden(N8_GOLDEN)
    _same_key(key, doc["key"])
    assert _jsonable(proof) == doc["proof"]


def test_n8_verifiers_agree(proven_n8):
    """The JAX verifier accepts the port's proof, the port's verifier the
    golden one; three tampered proofs fail both."""
    key, proof = proven_n8
    jkey = _jax_key(key)
    assert jf.fflonk_verify(jkey, proof)
    golden = convert.fflonk_proof_to_reference(_golden(N8_GOLDEN)["proof"])
    assert pf.fflonk_verify(key, golden)
    for name, bad in _tampered(proof).items():
        assert not pf.fflonk_verify(key, bad), name
        assert not jf.fflonk_verify(jkey, bad), name


def test_key_round_trip(proven_n8):
    """convert: the port's key as python ints and back, the reference's
    form (a JAX FflonkKey) into the port's."""
    key, _ = proven_n8
    fields = convert.fflonk_key_to_reference(key)
    jkey = _jax_key(key)
    back = convert.fflonk_key_from_reference(jkey, CPU)
    assert convert.fflonk_key_to_reference(back) == fields
    assert len(fields["srs_g1"]) == 9 * 8 + 32
    assert fields["srs_g1"][0] == G1_GEN
    assert jkey.cs.sigma == mul_circuit(15, 3, 5)[0]["sigma"]


@pytest.mark.parametrize("m", [0, 1, 63, 64, 65, 200])
def test_fused_poly_eval_twin_matches_horner_and_reference(m):
    """B2's fused evaluation (bn254_cuda.poly_eval's twin: mont_mul_plain
    of the coefficients and powers_plain, summed) against the host Horner
    at the top of fflonk.poly_eval and the JAX package's poly_eval, over a
    whole table and a strided slice (C1's a(X) = C1[0::4], as round 3
    reads it)."""
    rng = random.Random(m)
    coefs = [0, 1, FR - 1][:m] + [rng.randrange(FR) for _ in range(m - min(m, 3))]
    x = rng.randrange(FR)
    want = jf.poly_eval(coefs, x)
    assert pf.poly_eval(coefs, x) == want
    assert pf.poly_eval(_t(coefs), x) == want
    got = bn254_cuda.poly_eval(_t(coefs), x)
    assert got.shape == (4,) and _ints(got[None]) == [want]
    wide = _t([c for v in coefs for c in (v, 1, 2, 3)])
    assert pf.poly_eval(wide[0::4], x) == want
    assert pf.poly_eval(wide[1::4], x) == jf.poly_eval([1] * m, x)


def _seeded():
    n_vars, n_public, a, b, c, wit = seeded_r1cs()
    return R1CS(n_vars=n_vars, n_public=n_public, a=a, b=b, c=c), wit


def test_golden_files_hold_their_circuits():
    """The files carry the circuits they were proven on (chip_smoke.py
    proves them again on the card from the files alone)."""
    cs, a, b, c = mul_circuit(15, 3, 5)
    assert _golden(N8_GOLDEN)["circuit"] == {"cs": cs, "a": a, "b": b, "c": c}
    doc = _golden(PLONK_GOLDEN)
    r1cs, wit = _seeded()
    assert doc["witness"] == wit and doc["r1cs"] == json.loads(json.dumps({
        "n_vars": r1cs.n_vars, "n_public": r1cs.n_public,
        **{m: [sorted(d.items()) for d in getattr(r1cs, m)]
           for m in ("a", "b", "c")}}))


def _plonk_equal(port, ref):
    cs, av, bv, cv = port
    jcs, jav, jbv, jcv = ref
    assert convert.plonk_cs_to_reference(cs) == {
        "n": jcs.n, "n_public": jcs.n_public, "sigma": jcs.sigma,
        **{k: getattr(jcs, k) for k in convert.PLONK_SELECTORS}}
    assert convert.plonk_values_to_reference(av, bv, cv) == (jav, jbv, jcv)


@pytest.mark.parametrize("zero_coef", [False, True])
def test_r1cs_to_plonk_matches_reference_seeded(zero_coef):
    """Also with a coefficient that is 0 mod r (skipped as a term; the
    gate count then reads every entry)."""
    r1cs, wit = _seeded()
    if zero_coef:
        r1cs.a[5] = {**r1cs.a[5], 7: FR, 0: 0}
        r1cs.c[6] = {**r1cs.c[6], 4: 2 * FR}
    ref = jrt.r1cs_to_plonk(JaxR1CS(**vars(r1cs)), wit)
    _plonk_equal(prt.r1cs_to_plonk(r1cs, wit), ref)
    assert prt.plonk_size(r1cs) == (_gates(ref[0]), ref[0].n)
    assert [prt._chain_gates(m) is None for m in (r1cs.a, r1cs.b, r1cs.c)] \
        == [zero_coef, False, zero_coef]


def _gates(cs):
    """Rows before the padding of a reference PLONK system (a padding row
    has no selector and no copy)."""
    n = cs.n
    live = [i for i in range(n) if any(getattr(cs, k)[i] for k in
                                       convert.PLONK_SELECTORS)
            or any(cs.sigma[col * n + i] != col * n + i for col in range(3))]
    return max(live) + 1


def test_r1cs_to_plonk_matches_reference_golden_hop():
    """The golden tiny hop's final R1CS (223,758 constraints): n = 2^21."""
    from merlin_zkevm_prover_tpu_torch.models.smoke import build_smoke_air
    from merlin_zkevm_prover_tpu_torch.recursion import final_circuit as fc
    from merlin_zkevm_prover_tpu_torch.stark.compiler import compile_air
    from merlin_zkevm_prover_tpu_torch.stark.proof import StarkProof

    g = _golden(BN128_GOLDEN)
    air, _ = build_smoke_air(n_bits=g["n_bits"], seed=g["seed"])
    info = compile_air(air, **g["compile_air"])
    r1cs, wit = fc.build_final_r1cs(info, g["const_root"][0],
                                    StarkProof.from_json(json.dumps(g["proof"])))
    gates, n = prt.plonk_size(r1cs)
    port = prt.r1cs_to_plonk(r1cs, wit)
    assert port[0].n == n == 1 << 21
    ref = jrt.r1cs_to_plonk(r1cs, wit)
    assert ref[0].n == n
    _plonk_equal(port, ref)
    assert int(prt.constraint_gates(r1cs).sum()) + r1cs.n_public == gates


def test_jax_final_stage_contract_fault():
    """The reference fault: r1cs_to_plonk's lists run to n, but the JAX
    fflonk_prove takes at most n - 2 values a wire, so the JAX
    FinalStage._prove_fflonk (which passes them whole) cannot prove.  Here
    on out = x*y + 3x with one public."""
    x, y = 4, 9
    t = x * y
    wit = [1, t + 3 * x, x, y, t]
    r1cs = JaxR1CS(n_vars=5, n_public=1, a=[{2: 1}, {4: 1, 2: 3}],
                   b=[{3: 1}, {0: 1}], c=[{4: 1}, {1: 1}])
    cs, av, bv, cv = jrt.r1cs_to_plonk(r1cs, wit)
    assert cs.n == 8 and len(av) == 8
    key = jf.fflonk_setup(cs, seed=1)
    with pytest.raises(AssertionError, match="extend into the blinding"):
        jf.fflonk_prove(key, av, bv, cv, rand=b"\x02" * 32)


def test_final_stage_fflonk_route_equals_golden():
    """The port's FinalStage fflonk route (its _prove_fflonk, the JAX
    class's step after the R1CS build) proves the seeded R1CS equal to the
    JAX proof of its [:n - 2] lists, and both verifiers accept it (the
    tampered cases are test_n8_verifiers_agree's)."""
    r1cs, wit = _seeded()
    doc = _golden(PLONK_GOLDEN)
    stage = FinalStage(None, 0, setup_seed=PLONK_SEED, protocol="fflonk",
                       device="cpu")
    proof = stage._prove_fflonk(r1cs, wit, rand=PLONK_RAND)
    assert proof["verified"] and stage.key.cs.n == doc["n"]
    assert stage.stats["plonk_n"] == doc["n"]
    _same_key(stage.key, doc["key"])
    assert _jsonable(proof) == doc["proof"]
    assert jf.fflonk_verify(_jax_key(stage.key), proof)
    # an unsatisfied witness fails the prover's own checks
    bad_wit = list(wit)
    bad_wit[3] = (bad_wit[3] + 1) % FR
    with pytest.raises(ValueError):
        stage._prove_fflonk(r1cs, bad_wit, rand=PLONK_RAND)
