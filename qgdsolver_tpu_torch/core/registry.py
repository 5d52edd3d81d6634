"""Model registries: config words -> constructors (PyTorch port of
`qgdsolver_tpu.core.registry`, the OpenFOAM run-time selection tables).

Each registry maps a config word to a constructor, so case files select
tau-coefficient models, thermo pieces, BC types, and the combustion,
chemistrySolver, chemistryReduction and chemistryTabulation models
(`physics.chemistry`) by name.
"""
from __future__ import annotations

from collections import defaultdict

_REGISTRIES: dict = defaultdict(dict)


def register(kind: str, name: str):
    """Decorator: register `cls_or_fn` under (kind, name)."""

    def deco(obj):
        _REGISTRIES[kind][name] = obj
        return obj

    return deco


def create(kind: str, name: str, *args, **kwargs):
    try:
        ctor = _REGISTRIES[kind][name]
    except KeyError:
        raise KeyError(
            f"no {kind!r} registered under {name!r}; available: "
            f"{sorted(_REGISTRIES[kind])}"
        ) from None
    return ctor(*args, **kwargs)


def available(kind: str):
    return sorted(_REGISTRIES[kind])
