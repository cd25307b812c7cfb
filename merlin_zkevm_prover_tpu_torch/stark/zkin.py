"""Reference-artifact interop: jProof JSON export and zkin conversion.

The reference prover serializes STARK proofs to an ordered-JSON "jProof"
form (friProof -> json, reference src/starkpil/starkRecursiveF/
starkRecursiveF.cpp and friProof.hpp), converts them to circom-witness
"zkin" inputs with ``proof2zkinStark`` and merges recursive pairs with
``joinzkin`` (reference src/starkpil/fri/proof2zkinStark.cpp:8-175,
called from src/prover/prover.cpp in genBatchProof/genAggregatedProof).

This module reproduces those exact JSON shapes natively so proofs are
interchangeable with reference tooling, and so the captured production
artifacts at the reference root (jProofRecursiveF.json /
zkinRecursiveF.json) serve as golden vectors for the BN128 commitment
stack (tests/test_zkin.py).

jProof layout (both GL and BN128 committed proofs):
  root1..root4          cm-tree roots (4 felt strings for GL trees; one
                        Fr decimal string for BN128 trees)
  evals                 size_eval x 3 felt strings
  fri[0]                {"polQueries": [per-query [vals, siblings] x 5
                        trees (cm1..cm4, const)], "root": 0}
  fri[1..n-2]           {"polQueries": [per-query [vals, siblings]],
                        "root": step tree root}
  fri[n-1]              finalPol, 2^lastBits x 3 felt strings
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from .proof import StarkProof, TreeOpening

# step-0 tree order of the reference polQueries arrays
# (proof2zkinStark.cpp:55-77: 0=cm1, 1=cm2, 2=cm3, 3=cm4, 4=const)
STEP0_TREES = ("cm1", "cm2", "cm3", "cm4", "const")


def _felt(x) -> str:
    return str(int(x))


def _opening_json(op: Optional[TreeOpening]) -> list:
    """[values, siblings] pair; absent trees serialize as empty lists the
    way the reference emits unused cm2/cm3 sections (proof2zkinStark.cpp:
    32-39 keys off empty sibling arrays)."""
    if op is None:
        return [[], []]
    return [
        [_felt(v) for v in op.values],
        [[_felt(x) for x in level] for level in op.siblings],
    ]


def _opening_from_json(pair) -> Optional[TreeOpening]:
    vals, sibs = pair
    if not vals and not sibs:
        return None
    return TreeOpening(
        [int(v) for v in vals],
        [[int(x) for x in level] for level in sibs],
    )


def _root_json(root) -> object:
    """GL roots are 4-felt lists; BN128 roots a single Fr element."""
    if isinstance(root, (list, tuple)):
        return [_felt(x) for x in root]
    return _felt(root)


def proof_to_jproof(proof: StarkProof) -> dict:
    """Serialize a StarkProof into the reference jProof JSON shape."""
    out: dict = {}
    out["evals"] = [[_felt(x) for x in e] for e in proof.evals]
    fri: List[object] = []
    step0 = {
        "polQueries": [
            [_opening_json(q.get(t)) for t in STEP0_TREES]
            for q in proof.queries_step0
        ],
        "root": "0",
    }
    fri.append(step0)
    for si, step_queries in enumerate(proof.queries_fri):
        fri.append({
            "polQueries": [
                _opening_json(op) for op in step_queries
            ],
            "root": _root_json(proof.fri_roots[si]),
        })
    fri.append([[_felt(x) for x in e] for e in proof.final_pol])
    out["fri"] = fri
    for i, r in enumerate(proof.roots):
        out[f"root{i + 1}"] = _root_json(r)
    return out


def jproof_to_proof(j: dict, name: str = "jproof",
                    publics: Optional[List[int]] = None) -> StarkProof:
    """Parse a reference jProof JSON object back into a StarkProof."""
    fri = j["fri"]
    queries_step0 = []
    for q in fri[0]["polQueries"]:
        d: Dict[str, TreeOpening] = {}
        for t, pair in zip(STEP0_TREES, q):
            op = _opening_from_json(pair)
            if op is not None:
                d[t] = op
        queries_step0.append(d)
    queries_fri = []
    fri_roots = []
    for step in fri[1:-1]:
        queries_fri.append(
            [_opening_from_json(pair) for pair in step["polQueries"]]
        )
        r = step["root"]
        fri_roots.append(
            [int(x) for x in r] if isinstance(r, list) else int(r)
        )
    roots = []
    for i in range(1, 5):
        r = j[f"root{i}"]
        roots.append([int(x) for x in r] if isinstance(r, list) else int(r))
    return StarkProof(
        name=name,
        roots=roots,
        evals=[[int(x) for x in e] for e in j["evals"]],
        fri_roots=fri_roots,
        final_pol=[[int(x) for x in e] for e in fri[-1]],
        queries_step0=queries_step0,
        queries_fri=queries_fri,
        publics=list(publics or []),
    )


def proof2zkin_stark(jproof: dict) -> dict:
    """Native port of reference proof2zkinStark (proof2zkinStark.cpp:8-82):
    flatten a jProof into the circom-witness input naming."""
    zkin: dict = {}
    zkin["root1"] = jproof["root1"]
    zkin["root2"] = jproof["root2"]
    zkin["root3"] = jproof["root3"]
    zkin["root4"] = jproof["root4"]
    zkin["evals"] = jproof["evals"]

    fri = jproof["fri"]
    n_queries = len(fri[0]["polQueries"])
    for i in range(1, len(fri) - 1):
        zkin[f"s{i}_root"] = fri[i]["root"]
        zkin[f"s{i}_vals"] = [fri[i]["polQueries"][q][0]
                              for q in range(n_queries)]
        zkin[f"s{i}_siblings"] = [fri[i]["polQueries"][q][1]
                                  for q in range(n_queries)]

    q0 = fri[0]["polQueries"][0]
    has2 = bool(q0[1][0])
    has3 = bool(q0[2][0])
    for i in range(n_queries):
        pq = fri[0]["polQueries"][i]
        zkin.setdefault("s0_vals1", []).append(pq[0][0])
        zkin.setdefault("s0_siblings1", []).append(pq[0][1])
        if has2:
            zkin.setdefault("s0_vals2", []).append(pq[1][0])
            zkin.setdefault("s0_siblings2", []).append(pq[1][1])
        if has3:
            zkin.setdefault("s0_vals3", []).append(pq[2][0])
            zkin.setdefault("s0_siblings3", []).append(pq[2][1])
        zkin.setdefault("s0_vals4", []).append(pq[3][0])
        zkin.setdefault("s0_siblings4", []).append(pq[3][1])
        zkin.setdefault("s0_valsC", []).append(pq[4][0])
        zkin.setdefault("s0_siblingsC", []).append(pq[4][1])

    zkin["finalPol"] = fri[-1]
    return zkin


# zkin publics layout of the zkEVM batch proof
# (joinzkin, proof2zkinStark.cpp:88-122)
_PUB_OLD_STATE_ROOT = 0      # 8 felts
_PUB_OLD_ACC_INPUT = 8       # 8 felts
_PUB_OLD_BATCH_NUM = 16
_PUB_CHAIN_ID = 17
_PUB_FORK_ID = 18
_PUB_NEW_STATE_ROOT = 19     # 8 felts
_PUB_NEW_ACC_INPUT = 27      # 8 felts
_PUB_NEW_LOCAL_EXIT_ROOT = 35  # 8 felts
_PUB_NEW_BATCH_NUM = 43
N_PUBLICS = 44


def joinzkin(zkin1: dict, zkin2: dict, ver_key: dict, steps: int) -> dict:
    """Native port of reference joinzkin (proof2zkinStark.cpp:84-175):
    merge two consecutive batch zkins into the recursive2 input, chaining
    publics (old from zkin1, new from zkin2) and pinning the verifier
    constant root."""
    out: dict = {"publics": [None] * N_PUBLICS}
    p1, p2 = zkin1["publics"], zkin2["publics"]
    for i in range(8):
        out["publics"][_PUB_OLD_STATE_ROOT + i] = p1[_PUB_OLD_STATE_ROOT + i]
        out["publics"][_PUB_OLD_ACC_INPUT + i] = p1[_PUB_OLD_ACC_INPUT + i]
        out["publics"][_PUB_NEW_STATE_ROOT + i] = p2[_PUB_NEW_STATE_ROOT + i]
        out["publics"][_PUB_NEW_ACC_INPUT + i] = p2[_PUB_NEW_ACC_INPUT + i]
        out["publics"][_PUB_NEW_LOCAL_EXIT_ROOT + i] = (
            p2[_PUB_NEW_LOCAL_EXIT_ROOT + i])
    out["publics"][_PUB_OLD_BATCH_NUM] = p1[_PUB_OLD_BATCH_NUM]
    out["publics"][_PUB_CHAIN_ID] = p1[_PUB_CHAIN_ID]
    out["publics"][_PUB_FORK_ID] = p1[_PUB_FORK_ID]
    out["publics"][_PUB_NEW_BATCH_NUM] = p2[_PUB_NEW_BATCH_NUM]

    for prefix, zkin in (("a_", zkin1), ("b_", zkin2)):
        out[prefix + "publics"] = zkin["publics"]
        for k in ("root1", "root2", "root3", "root4", "evals",
                  "s0_vals1", "s0_vals3", "s0_vals4", "s0_valsC",
                  "s0_siblings1", "s0_siblings3", "s0_siblings4",
                  "s0_siblingsC"):
            if k in zkin:
                out[prefix + k] = zkin[k]
        for i in range(1, steps):
            out[f"{prefix}s{i}_root"] = zkin[f"s{i}_root"]
            out[f"{prefix}s{i}_siblings"] = zkin[f"s{i}_siblings"]
            out[f"{prefix}s{i}_vals"] = zkin[f"s{i}_vals"]
        out[prefix + "finalPol"] = zkin["finalPol"]

    out["rootC"] = [str(x) for x in ver_key["constRoot"]]
    return out


def dump_zkin(zkin: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(zkin, f)


def load_zkin(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
