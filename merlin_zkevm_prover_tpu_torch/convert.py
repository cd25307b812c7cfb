"""State carried across from the reference (JAX) package.

Everything here takes numpy arrays and plain python values, never a JAX
object, so this module imports no JAX.  The reference stores a field
element as two ``uint32`` planes ``(lo, hi)``; the port stores one 64-bit
word.  The tests use these functions so that both provers start from the
same constants.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

from .ops import goldilocks as gl
from .ops.goldilocks3 import GL3
from .stark import air as _air
from .stark import compiler as _compiler
from .stark.prover import StarkProver


def gl_from_limbs(lo, hi, device=None) -> gl.GL:
    """numpy uint32 planes of a reference ``GL`` -> the port's tensor."""
    lo = np.asarray(lo, dtype=np.uint32).astype(np.uint64)
    hi = np.asarray(hi, dtype=np.uint32).astype(np.uint64)
    return gl.from_u64(lo | (hi << np.uint64(32)), device)


def gl_to_limbs(t: gl.GL):
    """The port's tensor -> numpy uint32 planes (lo, hi)."""
    a = gl.to_u64(t)
    return ((a & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (a >> np.uint64(32)).astype(np.uint32))


def gl3_from_limbs(limbs, device=None) -> GL3:
    """((lo0, hi0), (lo1, hi1), (lo2, hi2)) of a reference ``GL3``."""
    return GL3(*[gl_from_limbs(lo, hi, device) for lo, hi in limbs])


def gl3_to_limbs(x: GL3):
    return tuple(gl_to_limbs(c) for c in (x.c0, x.c1, x.c2))


def info_fields_of(info) -> Dict[str, Any]:
    """The fields of a StarkInfo-shaped dataclass as a plain dict."""
    return {f.name: getattr(info, f.name) for f in dataclasses.fields(info)}


_PORT_CLASSES = {c.__name__: c for c in (
    _compiler.PolMap, _compiler.PuCtx, _compiler.PeCtx, _compiler.CiCtx,
    _compiler.StarkInfo)}


def _rebuild(obj, memo: dict):
    """Deep copy of host state into the port's own classes, matched by class
    name (expression nodes keep their sharing)."""
    if obj is None or isinstance(obj, (bool, int, str, float, np.generic)):
        return obj
    key = id(obj)
    if key in memo:
        return memo[key]
    cls = type(obj)
    if cls.__name__ == "Expr" and hasattr(obj, "kind"):
        out = _air.Expr(obj.kind, obj.id, obj.prime, obj.value,
                        tuple(_rebuild(a, memo) for a in obj.args))
    elif dataclasses.is_dataclass(obj) and cls.__name__ in _PORT_CLASSES:
        out = _PORT_CLASSES[cls.__name__](**{
            f.name: _rebuild(getattr(obj, f.name), memo)
            for f in dataclasses.fields(obj)})
    elif isinstance(obj, dict):
        out = {_rebuild(k, memo): _rebuild(v, memo) for k, v in obj.items()}
    elif isinstance(obj, (list, tuple)):
        out = cls(_rebuild(v, memo) for v in obj)
    else:
        raise TypeError(f"cannot carry {cls.__name__} across")
    memo[key] = out
    return out


def stark_info_from_fields(info_fields: Dict[str, Any]) -> _compiler.StarkInfo:
    """A port StarkInfo from the field dict of a reference one."""
    memo: dict = {}
    return _compiler.StarkInfo(
        **{k: _rebuild(v, memo) for k, v in info_fields.items()})


def prover_from_reference(info_fields: Dict[str, Any], const_n_lo,
                          const_n_hi, device=None) -> StarkProver:
    """A port StarkProver from the numpy state of a reference one: its
    StarkInfo's fields and the (lo, hi) planes of its ``const_n``."""
    lo = np.asarray(const_n_lo, dtype=np.uint32).astype(np.uint64)
    hi = np.asarray(const_n_hi, dtype=np.uint32).astype(np.uint64)
    return StarkProver(stark_info_from_fields(info_fields),
                       lo | (hi << np.uint64(32)), device=device)


# ---------------------------------------------------------------------------
# BN254: the reference's (..., 16) 16-bit limbs <-> the port's (..., 4)
# 64-bit limbs.  Both hold the same Montgomery residue (R = 2^256), so the
# conversion only regroups limbs.
# ---------------------------------------------------------------------------


def bn254_from_limbs16(a, device=None):
    """numpy (..., 16) 16-bit limbs (uint64 carrier) -> (..., 4) int64."""
    from .ops import bn254_field as bf

    a = np.asarray(a, dtype=np.uint64)
    v = a.reshape(a.shape[:-1] + (4, 4))
    words = (v[..., 0] | (v[..., 1] << np.uint64(16))
             | (v[..., 2] << np.uint64(32)) | (v[..., 3] << np.uint64(48)))
    return bf.from_u64(words, device)


def bn254_to_limbs16(t) -> np.ndarray:
    """(..., 4) int64 -> numpy (..., 16) 16-bit limbs (uint64 carrier)."""
    words = t.detach().cpu().numpy().view(np.uint64)
    shifts = np.array([0, 16, 32, 48], dtype=np.uint64)
    limbs = (words[..., :, None] >> shifts) & np.uint64(0xFFFF)
    return limbs.reshape(words.shape[:-1] + (16,))


def point_from_reference(F, p, device=None):
    """A reference ``Point`` (numpy leaves, ``Fq2El`` pairs over Fq2) ->
    the port's ``Point`` over the field interface F (``F1`` or ``F2``)."""
    from .snark import curve

    def leaf(x):
        if F is curve.F2:
            return curve.Fq2El(bn254_from_limbs16(x[0], device),
                               bn254_from_limbs16(x[1], device))
        return bn254_from_limbs16(x, device)

    return curve.Point(leaf(p[0]), leaf(p[1]), leaf(p[2]))


def groth16_key_from_reference(key, device=None):
    """A reference ``Groth16Key`` (points as numpy leaves) -> the port's,
    the coefficient table as numpy columns, the point tables affine
    (``msm.affine_bases``)."""
    from .snark import curve, msm
    from .snark.groth16 import Groth16Key
    from .snark.setup import Coefs

    F1, F2 = curve.F1, curve.F2

    def pt(F, p):
        return None if p is None else point_from_reference(F, p, device)

    def table(F, p):
        return None if p is None else msm.affine_bases(F, pt(F, p))

    return Groth16Key(
        n_vars=key.n_vars, n_public=key.n_public, domain_bits=key.domain_bits,
        coefs=Coefs.from_list(key.coefs),
        vk_alpha1=pt(F1, key.vk_alpha1), vk_beta1=pt(F1, key.vk_beta1),
        vk_delta1=pt(F1, key.vk_delta1), vk_beta2=pt(F2, key.vk_beta2),
        vk_delta2=pt(F2, key.vk_delta2),
        points_a=table(F1, key.points_a), points_b1=table(F1, key.points_b1),
        points_b2=table(F2, key.points_b2), points_c=table(F1, key.points_c),
        points_h=table(F1, key.points_h))


# ---------------------------------------------------------------------------
# fflonk: the reference's PLONK system, key and proof are python ints; the
# port keeps selectors as uint64 limbs and the polynomials and SRS on the
# device.  These give each side the other's form.
# ---------------------------------------------------------------------------

PLONK_SELECTORS = ("qL", "qR", "qM", "qO", "qC")


def plonk_cs_from_reference(cs):
    """A reference ``PlonkCS`` (lists of ints) -> the port's."""
    from .snark.fflonk import PlonkCS

    return PlonkCS(n=cs.n, **{k: getattr(cs, k) for k in PLONK_SELECTORS},
                   sigma=list(cs.sigma), n_public=cs.n_public)


def plonk_cs_to_reference(cs) -> Dict[str, Any]:
    """The port's ``PlonkCS`` -> the reference's fields as python ints
    (``PlonkCS(**fields)`` in the reference)."""
    from .ops import bn254_field as bf

    out: Dict[str, Any] = {"n": cs.n, "n_public": cs.n_public,
                           "sigma": [int(v) for v in cs.sigma]}
    for k in PLONK_SELECTORS:
        out[k] = bf.limbs_to_ints(getattr(cs, k))
    return out


def plonk_values_to_reference(*vals):
    """r1cs_to_plonk's (n, 4) limb columns -> the reference's int lists."""
    from .ops import bn254_field as bf

    return tuple(bf.limbs_to_ints(v) for v in vals)


def g1_words_from_affine(pairs, device=None):
    """Affine G1 points (python-int pairs, None for infinity) -> (m, 8)
    affine words (``msm.affine_bases``' form: the SRS's)."""
    from .snark import curve

    return curve.affine_words_from_ints(curve.F1, pairs, device)


def fflonk_key_from_reference(key, device=None):
    """A reference ``FflonkKey`` (python ints) -> the port's on `device`."""
    from .snark import fflonk as pf

    return pf.FflonkKey(
        cs=plonk_cs_from_reference(key.cs),
        srs_g1=g1_words_from_affine(key.srs_g1, device), x2=key.x2,
        C0=key.C0, c0_coefs=pf.fr_tensor(key.c0_coefs, device),
        sel_coefs={k: pf.fr_tensor(v, device)
                   for k, v in key.sel_coefs.items()},
        sigma_coefs=[pf.fr_tensor(v, device) for v in key.sigma_coefs],
        w=key.w)


def fflonk_key_to_reference(key) -> Dict[str, Any]:
    """The port's ``FflonkKey`` -> the reference's fields as python ints
    (``FflonkKey(**fields)`` in the reference, ``cs`` a field dict)."""
    from .snark import curve
    from .snark import fflonk as pf

    return {"cs": plonk_cs_to_reference(key.cs),
            "srs_g1": curve.affine_ints(curve.F1, key.srs_g1),
            "x2": key.x2, "C0": key.C0,
            "c0_coefs": pf.fr_ints(key.c0_coefs),
            "sel_coefs": {k: pf.fr_ints(v) for k, v in key.sel_coefs.items()},
            "sigma_coefs": [pf.fr_ints(v) for v in key.sigma_coefs],
            "w": key.w}


def fflonk_proof_to_reference(proof) -> Dict[str, Any]:
    """A fflonk proof dict with its points as tuples and its scalars as
    python ints (either package's proof; JSON gives lists)."""
    out = dict(proof)
    for k in ("C1", "C2", "W1", "W2"):
        p = proof[k]
        out[k] = None if p is None else (int(p[0]), int(p[1]))
    out["evals"] = {k: int(v) for k, v in proof["evals"].items()}
    out["publics"] = [int(v) for v in proof["publics"]]
    return out
