"""Model registries: config words -> constructors (PyTorch port of
`qgdsolver_tpu.core.registry`, the OpenFOAM run-time selection tables).

Each registry maps a config word to a constructor, so case files select
tau-coefficient models, thermo pieces and BC types by name.  A word the JAX
package has and this port does not yet is registered as missing with the
ROADMAP item it waits for: `create` then raises NotImplementedError naming
that item instead of a bare KeyError.
"""
from __future__ import annotations

from collections import defaultdict

_REGISTRIES: dict = defaultdict(dict)
_MISSING: dict = defaultdict(dict)


def register(kind: str, name: str):
    """Decorator: register `cls_or_fn` under (kind, name)."""

    def deco(obj):
        _REGISTRIES[kind][name] = obj
        return obj

    return deco


def register_missing(kind: str, what: str, *names: str) -> None:
    """Mark config words the port does not have yet; `what` says which
    ROADMAP item they wait for."""
    for name in names:
        _MISSING[kind][name] = what


def create(kind: str, name: str, *args, **kwargs):
    try:
        ctor = _REGISTRIES[kind][name]
    except KeyError:
        if name in _MISSING[kind]:
            raise NotImplementedError(
                f"{kind} {name!r} is not in the PyTorch port yet: "
                f"{_MISSING[kind][name]}") from None
        raise KeyError(
            f"no {kind!r} registered under {name!r}; available: "
            f"{sorted(_REGISTRIES[kind])}"
        ) from None
    return ctor(*args, **kwargs)


def available(kind: str):
    return sorted(_REGISTRIES[kind])
