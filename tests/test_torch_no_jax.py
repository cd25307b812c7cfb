"""The port imports torch and numpy, never jax and nothing of the JAX
package: checked in a fresh interpreter for every module of the port and
for chip_smoke.py."""

import ast
import os
import pkgutil
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, sys
sys.path.insert(0, {root!r})
for name in {modules!r}:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.split(".")[0] == "merlin_zkevm_prover_tpu")
print("LEAKED=" + ",".join(bad))
"""


def _port_modules():
    pkg_dir = os.path.join(ROOT, "merlin_zkevm_prover_tpu_torch")
    names = ["merlin_zkevm_prover_tpu_torch"]
    for m in pkgutil.walk_packages([pkg_dir], "merlin_zkevm_prover_tpu_torch."):
        names.append(m.name)
    return names


def _leaked(modules):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(root=ROOT, modules=modules)],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    line = [l for l in out.stdout.splitlines() if l.startswith("LEAKED=")][-1]
    return line[len("LEAKED="):]


def test_port_has_every_expected_module():
    names = _port_modules()
    for sub in ("ops.goldilocks", "ops.goldilocks3", "ops.scan_utils",
                "ops.poseidon_gl", "ops.poseidon_cuda", "ops.ntt",
                "ops.ntt_cuda", "ops.cuda_build", "stark.prover",
                "stark.verifier", "stark.fri", "stark.device_core",
                "stark.evaluator", "stark.plookup", "stark.merkle_tree",
                "models.smoke", "utils.timer", "convert", "stark.vm",
                "ops.vm_cuda", "stark.checkpoint", "stark.pil_importer",
                "stark.zkin", "recursion.gates", "recursion.plonk",
                "recursion.verifier_circuit", "recursion.recursive",
                "ops.bn254_field", "ops.bn254_cuda", "ops.poseidon_bn254",
                "ops.poseidon_bn254_constants", "ops.poseidon_bn254_cuda",
                "stark.merkle_bn128", "stark.prover_bn128", "snark.curve",
                "snark.fft", "snark.msm", "snark.setup", "snark.groth16",
                "snark.pairing", "snark.binfile", "recursion.final_circuit",
                "recursion.final", "tools.bn254_times", "utils.keccak",
                "snark.fflonk", "snark.r1cs_to_plonk",
                "ops.bn254_fflonk_cuda", "tools.fflonk_times",
                "utils.config", "utils.watchdog", "native", "ops.secp256k1",
                "executor", "executor.ecrecover", "hashdb", "hashdb.database",
                "hashdb.smt", "hashdb.state_manager", "hashdb.hashdb",
                "hashdb.hashdb64", "executor.sm",
                "executor.sm.poseidon_g_executor",
                "executor.sm.arith_executor", "executor.sm.binary_executor",
                "executor.sm.memory_executor",
                "executor.sm.mem_align_executor"):
        assert f"merlin_zkevm_prover_tpu_torch.{sub}" in names


def test_importing_every_port_module_pulls_in_no_jax():
    assert _leaked(_port_modules()) == ""


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py's imports: the module itself (its main() is not run)
    and everything its main() imports."""
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert not re.search(
        r"^\s*(from|import)\s+(jax|merlin_zkevm_prover_tpu)(\.|\s|$)", src, re.M)
    wanted = ["chip_smoke"]
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("merlin_zkevm_prover_tpu_torch"):
            wanted.append(node.module)
            for alias in node.names:  # `from pkg import submodule` forms
                sub = os.path.join(ROOT, *node.module.split("."), alias.name)
                if os.path.exists(sub + ".py") or os.path.isdir(sub):
                    wanted.append(f"{node.module}.{alias.name}")
    assert len(wanted) > 8
    assert _leaked(wanted) == ""


def test_chip_smoke_fails_without_a_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run in full")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
