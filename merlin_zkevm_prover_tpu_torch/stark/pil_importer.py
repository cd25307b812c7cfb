"""Compiled-PIL (pilcom JSON) importer.

Loads the reference's compiled constraint systems (e.g.
src/main_sm/fork_5/scripts/main.pil.json: 665 committed polynomials, 218
constants, 631 polynomial identities, 28 plookups, 18 permutations, 2
connections) into the framework's AIR, from which `compile_air` produces
the proving StarkInfo.  This replaces the pil-stark starkinfo pipeline the
reference depends on offline.

Constant-polynomial *values* are not part of the PIL JSON (pil-stark
generates them in buildConstants); pass them via `const_values` or leave
zeros for structural use.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Optional

import numpy as np

from ..ops.goldilocks import P
from .air import AIR, Expr
from .compiler import rotate


def import_pil(source, const_values: Optional[np.ndarray] = None,
               name: str = "pil", n_bits: Optional[int] = None,
               reparam_jmpn: bool = False) -> AIR:
    """source: path or parsed pilcom JSON -> AIR.

    `n_bits` overrides the PIL's declared polDeg to instantiate the same
    constraint system on a reduced domain (public-input rows pinned to the
    last row remap to the new last row; constants must be rebuilt for the
    reduced domain by the caller, e.g. the JAX package's
    models/zkevm_constants.build_all).

    `reparam_jmpn` (reduced domains only): the JMPN decomposition identity
    (fork_5 main.pil:222) bakes N = 2^23 into its coefficients — op0 is
    split as `isNeg*2^32 + op0 = sum(bit_j * 2^(23+j)) + lJmpnCondValue`
    with lJmpnCondValue range-checked against the N-row STEP table.  The
    same source generated at N = 2^n yields coefficients 2^(n+j) and
    isNeg*2^(n+9); this flag applies that rewrite so the identity matches
    a reduced-domain executor trace (the JAX package's
    executor/main_executor.py jmpn_low_bits).  Off by default: conformance
    against reference-exact traces keeps the shipped coefficients."""
    if isinstance(source, str):
        with open(source) as f:
            pil = json.load(f)
    else:
        pil = source

    n_commitments = pil["nCommitments"]
    n_constants = pil["nConstants"]
    # degree from any reference
    pol_deg = None
    for ref in pil["references"].values():
        pol_deg = ref.get("polDeg")
        if pol_deg:
            break
    decl_bits = int(math.log2(pol_deg))
    assert (1 << decl_bits) == pol_deg
    if n_bits is None:
        n_bits = decl_bits

    air = AIR(name, n_bits)
    air.cm_names = [f"cm{i}" for i in range(n_commitments)]
    # constant columns: values are provided at prove time (pil-stark's
    # buildConstants role); register names only to avoid materializing
    # 2^23-row zero columns here
    for i in range(n_constants):
        air.const_names.append(f"const{i}")
        air.const_values.append(
            None if const_values is None else
            const_values[:, i].astype(np.uint64)
        )

    # name the references for debuggability (arrays expand to name[i])
    for ref_name, ref in pil["references"].items():
        rid = ref["id"]
        count = ref.get("len", 1) if ref.get("isArray") else 1
        names = air.cm_names if ref["type"] == "cmP" else (
            air.const_names if ref["type"] == "constP" else None
        )
        if names is None:
            continue
        for k in range(count):
            if rid + k < len(names):
                names[rid + k] = ref_name if count == 1 else f"{ref_name}[{k}]"

    expressions = pil["expressions"]
    memo: Dict[int, Expr] = {}

    def build(e: dict) -> Expr:
        op = e["op"]
        if op == "cm":
            ex = Expr("cm", id=e["id"])
            return rotate(ex) if e.get("next") else ex
        if op == "const":
            ex = Expr("const", id=e["id"])
            return rotate(ex) if e.get("next") else ex
        if op == "number":
            s = str(e["value"])
            v = int(s, 16) if s.startswith("0x") else int(s)
            return Expr("number", value=v % P)
        if op == "public":
            return Expr("public", id=e["id"])
        if op == "exp":
            sub = resolve(e["id"])
            return rotate(sub) if e.get("next") else sub
        if op == "add":
            return build(e["values"][0]) + build(e["values"][1])
        if op == "sub":
            return build(e["values"][0]) - build(e["values"][1])
        if op == "mul":
            return build(e["values"][0]) * build(e["values"][1])
        if op == "neg":
            return -build(e["values"][0])
        raise ValueError(f"unknown PIL expression op '{op}'")

    def resolve(eid: int) -> Expr:
        if eid not in memo:
            memo[eid] = build(expressions[eid])
        return memo[eid]

    # publics: bound to committed polynomial values at a row, enforced with
    # a row-selector constraint (the reference enforces the binding in the
    # circom verifier instead)
    for pub in sorted(pil.get("publics", []), key=lambda p: p["id"]):
        assert pub["polType"] == "cmP", pub
        assert pub["id"] == len(air.publics)
        idx = pub["idx"]
        if idx == pol_deg - 1:
            idx = (1 << n_bits) - 1  # last-row publics track the domain
        assert idx < (1 << n_bits), (pub, n_bits)
        air.publics.append((pub["name"], pub["polId"], idx))
        lrow = air.row_selector(idx)
        air.constraint(
            lrow * (Expr("cm", id=pub["polId"]) - Expr("public", id=pub["id"]))
        )

    # identities
    jmpn_cm = None
    if reparam_jmpn and n_bits < decl_bits:
        for ref_name, ref in pil["references"].items():
            if ref_name.endswith(".lJmpnCondValue"):
                jmpn_cm = ref["id"]
        pow2_map = {1 << (decl_bits + j): 1 << (n_bits + j)
                    for j in range(10)}

        def has_jmpn(e: Expr, memo2: dict) -> bool:
            h = memo2.get(e)
            if h is None:
                h = (e.kind == "cm" and e.id == jmpn_cm) or any(
                    has_jmpn(a, memo2) for a in e.args)
                memo2[e] = h
            return h

        def remap(e: Expr, memo2: dict) -> Expr:
            h = memo2.get(e)
            if h is None:
                if e.kind == "number" and e.value in pow2_map:
                    h = Expr("number", value=pow2_map[e.value])
                elif e.args:
                    h = Expr(e.kind, id=e.id, prime=e.prime, value=e.value,
                             args=tuple(remap(a, memo2) for a in e.args))
                else:
                    h = e
                memo2[e] = h
            return h

    for ident in pil["polIdentities"]:
        e = resolve(ident["e"])
        if jmpn_cm is not None and has_jmpn(e, {}):
            e = remap(e, {})
        air.constraint(e)
    for ident in pil.get("plookupIdentities", []):
        f = [resolve(i) for i in ident["f"]]
        t = [resolve(i) for i in ident["t"]]
        f_sel = resolve(ident["selF"]) if ident.get("selF") is not None else None
        t_sel = resolve(ident["selT"]) if ident.get("selT") is not None else None
        air.lookup(f, t, f_sel, t_sel)
    for ident in pil.get("permutationIdentities", []):
        f = [resolve(i) for i in ident["f"]]
        t = [resolve(i) for i in ident["t"]]
        f_sel = resolve(ident["selF"]) if ident.get("selF") is not None else None
        t_sel = resolve(ident["selT"]) if ident.get("selT") is not None else None
        air.permutation(f, t, f_sel, t_sel)
    for ident in pil.get("connectionIdentities", []):
        cols = [resolve(i) for i in ident["pols"]]
        s_cols = [resolve(i) for i in ident["connections"]]
        air.connection(cols, s_cols)

    return air
