"""One live run of the JAX prover against the port (a file of its own, so
that a per-file test scheduler gives it a worker to itself).

The reference prover runs through its bounded-compile route (12-node
evaluation chunks, matrix step 5: its own ``MERLIN_STEP_MAX_NODES`` and
``MERLIN_STEP5_MATRIX_MIN`` settings), whose XLA compiles fit in minutes on
the CPU; its default route takes hours there and gives the same proof.
Tolerance: none, every field must be equal."""

import json

import numpy as np
import torch

torch.set_num_threads(1)


def test_live_reference_proof_equals_port_and_golden(monkeypatch):
    monkeypatch.setenv("MERLIN_STEP_MAX_NODES", "12")
    monkeypatch.setenv("MERLIN_STEP5_MATRIX_MIN", "0")
    from merlin_zkevm_prover_tpu.models.smoke import build_smoke_air as ref_build
    from merlin_zkevm_prover_tpu.stark import StarkProver as RefProver
    from merlin_zkevm_prover_tpu.stark import compile_air as ref_compile
    from merlin_zkevm_prover_tpu_torch.models.smoke import build_smoke_air
    from merlin_zkevm_prover_tpu_torch.stark import StarkProver, compile_air
    from test_torch_stark_e2e import PROOF_FIELDS, SEED, SETTINGS, load_golden

    rair, rtrace = ref_build(n_bits=5, seed=SEED)
    rprover = RefProver(ref_compile(rair, **SETTINGS[5]),
                        np.stack(rair.const_values, axis=1))
    ref = json.loads(rprover.prove(rtrace).to_json())

    air, trace = build_smoke_air(n_bits=5, seed=SEED)
    prover = StarkProver(compile_air(air, **SETTINGS[5]),
                         np.stack(air.const_values, axis=1), device="cpu")
    mine = json.loads(prover.prove(trace).to_json())
    golden = load_golden(5)

    assert rprover.const_tree.root() == prover.const_tree.root() \
        == golden["const_root"]
    assert set(ref) == set(mine) == set(golden["proof"])
    for key in ref:
        assert ref[key] == mine[key] == golden["proof"][key], key
    assert len(ref) == len(PROOF_FIELDS) + 1  # every field, and the name
