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
