"""The port's host utilities (utils/config.py, utils/watchdog.py, native.py,
ops/secp256k1.py, executor/ecrecover.py) against the JAX package's.

Tolerance: none.  Configs compare field by field, the native routines and
their python fallbacks word by word, curve points, addresses and error
codes as python ints.
"""

import dataclasses
import json
import os
import random
import sys
import threading
import time

import numpy as np
import pytest
import torch

# the suite runs several workers side by side: one thread each
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from merlin_zkevm_prover_tpu import native as jax_native  # noqa: E402
from merlin_zkevm_prover_tpu.executor import ecrecover as jax_ecr  # noqa: E402
from merlin_zkevm_prover_tpu.ops import secp256k1 as jax_ec  # noqa: E402
from merlin_zkevm_prover_tpu.utils.config import Config as JaxConfig  # noqa: E402
from merlin_zkevm_prover_tpu_torch import native  # noqa: E402
from merlin_zkevm_prover_tpu_torch.executor import ecrecover as ecr  # noqa: E402
from merlin_zkevm_prover_tpu_torch.ops import secp256k1 as ec  # noqa: E402
from merlin_zkevm_prover_tpu_torch.ops.goldilocks import P  # noqa: E402
from merlin_zkevm_prover_tpu_torch.utils import watchdog  # noqa: E402
from merlin_zkevm_prover_tpu_torch.utils.config import Config  # noqa: E402
from merlin_zkevm_prover_tpu_torch.utils.keccak import keccak256  # noqa: E402

# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

CONFIG_JSON = {
    "runFileGenBatchProof": True, "inputFile": "batch.json",
    "runFileExecute": "exec.json", "runAggregatorClient": False,
    "executorServerPort": 50099, "hashDB64": True, "rom": "rom.json",
    "databaseURL": "state.db", "proverNBits": 17, "maxProverThreads": 3,
    "unknownKey": [1, 2, 3], "ECRecoverPrecalc": True,
}


def _same_config(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.print() == b.print()
    assert a.generate_proof() == b.generate_proof()


def test_config_fields_match_the_jax_package():
    assert [(f.name, f.type, f.default) for f in dataclasses.fields(Config)
            if f.name != "extra"] == \
        [(f.name, f.type, f.default) for f in dataclasses.fields(JaxConfig)
         if f.name != "extra"]
    _same_config(Config(), JaxConfig())


@pytest.mark.parametrize("source", ["dict", "file"])
def test_config_load_matches_the_jax_package(source, tmp_path):
    if source == "file":
        path = tmp_path / "config.json"
        path.write_text(json.dumps(CONFIG_JSON))
        arg = str(path)
    else:
        arg = dict(CONFIG_JSON)
    got, want = Config.load(arg), JaxConfig.load(arg)
    _same_config(got, want)
    assert got.runFileGenBatchProof == "batch.json"   # bool -> inputFile
    assert got.romFile == "rom.json"
    assert got.extra == {"unknownKey": [1, 2, 3]}
    assert got.generate_proof()


def test_config_environment_overrides(monkeypatch):
    monkeypatch.setenv("EXECUTOR_SERVER_PORT", "4242")
    monkeypatch.setenv("HASHDB64", "false")
    monkeypatch.setenv("MAX_PROVER_THREADS", "not a number")
    monkeypatch.setenv("PROVER_NAME", "card-prover")
    got, want = Config.load(dict(CONFIG_JSON)), JaxConfig.load(dict(CONFIG_JSON))
    _same_config(got, want)
    assert (got.executorServerPort, got.hashDB64, got.maxProverThreads,
            got.proverName) == (4242, False, 3, "card-prover")


# ---------------------------------------------------------------------------
# Watchdog
# ---------------------------------------------------------------------------


def test_watchdog_fires_and_calls_back():
    hit = threading.Event()
    dog = watchdog.Watchdog(0.05, on_timeout=hit.set)
    dog.start()
    assert hit.wait(5.0)
    assert dog.fired
    dog.stop()


def test_watchdog_without_callback_logs(monkeypatch):
    logged = []
    from merlin_zkevm_prover_tpu_torch.utils import zklog

    monkeypatch.setattr(zklog.zklog, "error", logged.append)
    dog = watchdog.Watchdog(0.02)
    dog.start()
    deadline = time.time() + 5.0
    while not dog.fired and time.time() < deadline:
        time.sleep(0.01)
    assert dog.fired
    assert logged == ["Watchdog timeout after 0.02s"]


def test_watchdog_cancelled_and_kicked():
    hit = threading.Event()
    with watchdog.Watchdog(0.2, on_timeout=hit.set) as dog:
        for _ in range(3):          # each kick restarts the countdown
            time.sleep(0.1)
            dog.kick()
    assert not hit.wait(0.4)        # stopped on exit: never fires
    assert not dog.fired and dog._timer is None


# ---------------------------------------------------------------------------
# native (the shared native/libzkio.so) and its python fallbacks
# ---------------------------------------------------------------------------


def _states(seed, n):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 1 << 64, (n, 12), dtype=np.uint64)
    s[0, :4] = [P, P + 1, (1 << 64) - 1, 0]
    return s


@pytest.fixture(params=["library", "fallback"])
def port_native(request, monkeypatch):
    """The port's native module, with its library or without it."""
    if request.param == "library":
        if not native.available():
            pytest.skip("native/libzkio.so does not load here")
    else:
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", True)
    return native


def test_native_shares_the_repo_library():
    assert native._LIB_PATH == jax_native._LIB_PATH
    assert native._LIB_PATH.endswith(os.path.join("native", "libzkio.so"))


def test_native_permute_matches_the_jax_package(port_native):
    states = _states(7, 9)
    for row in states:
        st = [int(v) for v in row]
        assert port_native.poseidon_permute(st) == \
            jax_native.poseidon_permute(st)
    np.testing.assert_array_equal(port_native.poseidon_permute_batch(states),
                                  jax_native.poseidon_permute_batch(states))


def test_native_keccak_matches_the_jax_package(port_native):
    rng = np.random.default_rng(8)
    for _ in range(3):
        st = [int(v) for v in rng.integers(0, 1 << 64, 25, dtype=np.uint64)]
        assert port_native.keccak_f1600(list(st)) == \
            jax_native.keccak_f1600(list(st))


def test_native_limbs_and_pols_files(port_native, tmp_path):
    rng = np.random.default_rng(9)
    x = rng.integers(0, 1 << 64, (33, 5), dtype=np.uint64)
    lo, hi = port_native.u64_to_u32pair(x)
    jlo, jhi = jax_native.u64_to_u32pair(x)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    np.testing.assert_array_equal(port_native.u32pair_to_u64(lo, hi), x)
    path = str(tmp_path / "cm.pols")
    port_native.write_pols(path, x)
    np.testing.assert_array_equal(jax_native.read_pols(path, shape=x.shape), x)
    np.testing.assert_array_equal(port_native.read_pols(path, shape=x.shape), x)


# ---------------------------------------------------------------------------
# secp256k1 and ECRecover
# ---------------------------------------------------------------------------


def _point_cases(rng):
    g = (ec.GX, ec.GY)
    pts = [None, g, ec.dbl(g), (ec.GX, ec.P - ec.GY)]
    for _ in range(3):
        pts.append(ec.mul(rng.getrandbits(256), g))
    return pts


def test_secp256k1_matches_the_jax_package():
    rng = random.Random(11)
    pts = _point_cases(rng)
    for a in pts:
        assert ec.is_on_curve(a) and jax_ec.is_on_curve(a)
        assert ec.dbl(a) == jax_ec.dbl(a)
        for b in pts:
            assert ec.add(a, b) == jax_ec.add(a, b)
    g = (ec.GX, ec.GY)
    for k in (0, 1, 2, ec.N - 1, ec.N, ec.N + 5, rng.getrandbits(256)):
        assert ec.mul(k, g) == jax_ec.mul(k, g)
    k1, k2 = rng.getrandbits(256), rng.getrandbits(256)
    assert ec.mul2(k1, g, k2, pts[4]) == jax_ec.mul2(k1, g, k2, pts[4])
    for x in (0, 2, 3, rng.getrandbits(255), ec.P - 1):
        assert ec.sqrt_p(x) == jax_ec.sqrt_p(x)
        if x:
            assert ec.inv_p(x) == jax_ec.inv_p(x)
            assert ec.inv_n(x) == jax_ec.inv_n(x)
    assert (ec.P, ec.N, ec.GX, ec.GY, ec.A, ec.B) == \
        (jax_ec.P, jax_ec.N, jax_ec.GX, jax_ec.GY, jax_ec.A, jax_ec.B)


def _address(priv):
    pub = ec.mul(priv, (ec.GX, ec.GY))
    return int.from_bytes(keccak256(pub[0].to_bytes(32, "big")
                                    + pub[1].to_bytes(32, "big"))[12:], "big")


def test_ecrecover_on_seeded_signatures():
    rng = random.Random(12)
    for _ in range(4):
        priv = rng.getrandbits(256) % ec.N
        digest = rng.getrandbits(256) % ec.N
        k = rng.getrandbits(256) % ec.N
        sig = ecr.sign_for_test(digest, priv, k)
        assert sig == jax_ecr.sign_for_test(digest, priv, k)
        got = ecr.ecrecover(digest, *sig)
        assert got == jax_ecr.ecrecover(digest, *sig)
        assert got == (_address(priv), ecr.ECR_NO_ERROR)
        # v as 0 / 1 recovers the same address
        r, s, v = sig
        assert ecr.ecrecover(digest, r, s, v - 27) == got


def test_ecrecover_error_paths_match_the_jax_package():
    digest = 123456789
    priv, k = 999331, 777789
    r, s, v = ecr.sign_for_test(digest, priv, k)
    high_s = ec.N - s
    flip_v = 27 + (1 - (v - 27))
    no_sqrt = next(x for x in range(1, 100)
                   if ec.sqrt_p((pow(x, 3, ec.P) + ec.B) % ec.P) is None)
    cases = [
        ((digest, 0, 5, 27), ecr.ECR_R_IS_ZERO),
        ((digest, ec.N, 5, 27), ecr.ECR_R_IS_TOO_BIG),
        ((digest, r, 0, v), ecr.ECR_S_IS_ZERO),
        ((digest, r, high_s, flip_v), ecr.ECR_S_IS_TOO_BIG),
        ((digest, r, s, 29), ecr.ECR_V_INVALID),
        ((digest, no_sqrt, s, 27), ecr.ECR_NO_SQRT_Y),
    ]
    for args, err in cases:
        got = ecr.ecrecover(*args)
        assert got == jax_ecr.ecrecover(*args) == (0, err)
    # EIP-2 high s: rejected for transactions, accepted by the precompile
    got = ecr.ecrecover(digest, r, high_s, flip_v, precompiled=True)
    assert got == jax_ecr.ecrecover(digest, r, high_s, flip_v,
                                    precompiled=True)
    assert got == (_address(priv), ecr.ECR_NO_ERROR)
    assert [getattr(ecr, n) for n in dir(ecr) if n.startswith("ECR_")] == \
        [getattr(jax_ecr, n) for n in dir(jax_ecr) if n.startswith("ECR_")]
