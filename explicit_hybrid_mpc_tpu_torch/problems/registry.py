"""Benchmark problem registry (the reference dispatches examples by CLI name;
SURVEY.md section 3 "CLI / entry", [M-med])."""

from __future__ import annotations

import importlib

_REGISTRY: dict[str, type] = {}

_MODULES = ("double_integrator", "mass_spring", "inverted_pendulum",
            "satellite", "satellite_soc", "quadrotor")


def register(cls):
    _REGISTRY[cls.name] = cls
    return cls


def _load_all() -> None:
    for mod in _MODULES:
        full = f"explicit_hybrid_mpc_tpu_torch.problems.{mod}"
        # Skip not-yet-implemented modules, but surface real import errors
        # from modules that do exist.
        if importlib.util.find_spec(full) is not None:
            importlib.import_module(full)


def make(name: str, **kwargs):
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown problem {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def names() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)
