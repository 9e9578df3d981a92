"""Runtime recompile sentinel: fail loudly when a "steady" phase mints
new device program shapes or loads new kernels.

The static rules (analysis/rules/) catch recompile HAZARDS; this guard
catches recompile FACTS.  The oracle keeps an exact ledger of every
(program family, padded rows) shape it dispatched
(``Oracle.compiled_shapes``, the JAX package's ledger kept by the port:
with power-of-two padding it bounds the shapes the IPM leg is launched
at, and the shapes a CUDA graph per bucket would be captured for), and
anything that caches compiled variants exposes their count through
``_cache_size()`` -- the port's counterpart of a jit cache is its
kernel loader (``kernels.loader``: the libraries built or loaded into
the process).  The guard snapshots either (or both) at ``arm()`` and,
at ``check()`` / context exit, treats ANY growth as a finding:

- ``action='warn'``: emit a ``health.recompile`` event (severity warn)
  into the obs stream -- the in-build HealthMonitor folds it into its
  verdict -- then RE-ARM, so a churning phase reports each new shape
  once, not every step.
- ``action='raise'``: raise ``RecompileError`` (the test/CI mode; the
  frontier's ``cfg.recompile_guard='raise'`` aborts the build).

Wired into the frontier's steady-state wave loop by
``cfg.recompile_guard`` / ``--recompile-guard`` (the engine arms after
a warmup of full-size batches -- ramp-up and drain-down legitimately
mint new pow-2 buckets; a FULL batch minting a shape mid-campaign is
the bug).  Standalone use around any phase::

    with RecompileGuard(watch=[kernels.loader], action="raise"):
        build_partition(problem, cfg)   # loads K1 mid-phase: raises

No torch import: probes are duck-typed (``compiled_shapes`` set,
``_cache_size()`` method), so the guard is constructible in tests and
host tooling without touching the accelerator stack.  The semantics
and the event's fields are the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Sequence

_ACTIONS = ("warn", "raise")


class RecompileError(RuntimeError):
    """A guarded phase minted new device program shapes or kernels."""


class RecompileGuard:
    """Snapshot/compare compiled-program ledgers around a build phase.

    Parameters:
        oracle: object with a ``compiled_shapes`` set attribute
            (oracle.Oracle; anything duck-typed works).
        watch: objects probed via ``_cache_size()`` (kernels.loader,
            or any cache of compiled variants).
        obs: Obs handle for the ``health.recompile`` event (NOOP-safe;
            when None or disabled the event dict is still RETURNED so
            callers can feed an in-process HealthMonitor).
        action: 'warn' (emit + return the event) or 'raise'.
        label: phase name stamped into events/errors.
    """

    def __init__(self, oracle=None, watch: Sequence = (),
                 obs=None, action: str = "warn",
                 label: str = "steady_state"):
        if action not in _ACTIONS:
            raise ValueError(f"unknown action {action!r} "
                             f"(expected one of {_ACTIONS})")
        if oracle is None and not watch:
            raise ValueError("RecompileGuard needs an oracle (with a "
                             "compiled_shapes ledger) and/or watch= "
                             "probes")
        if oracle is not None and not hasattr(oracle, "compiled_shapes"):
            raise ValueError("oracle has no compiled_shapes ledger; "
                             "pass watch= probes instead")
        self._watch = list(watch)
        for fn in self._watch:
            if not callable(getattr(fn, "_cache_size", None)):
                raise ValueError(
                    f"watch target {fn!r} has no _cache_size(); pass "
                    "kernels.loader or another cache of compiled "
                    "variants")
        self.oracle = oracle
        self.obs = obs
        self.action = action
        self.label = label
        self.n_violations = 0
        self._shapes0: Optional[frozenset] = None
        self._cache0: Optional[list[int]] = None
        self.arm()

    # -- snapshot / compare ------------------------------------------------

    def arm(self) -> None:
        """(Re)take the baseline snapshot; growth is measured from the
        most recent arm."""
        if self.oracle is not None:
            self._shapes0 = frozenset(self.oracle.compiled_shapes)
        self._cache0 = [int(fn._cache_size()) for fn in self._watch]

    def new_shapes(self) -> list[tuple]:
        """Oracle ledger entries added since arm() (sorted)."""
        if self.oracle is None:
            return []
        return sorted(set(self.oracle.compiled_shapes) - self._shapes0)

    def cache_growth(self) -> int:
        """Total cache entries added across watch targets."""
        return sum(int(fn._cache_size()) - c0
                   for fn, c0 in zip(self._watch, self._cache0))

    def check(self, **fields) -> Optional[dict]:
        """Compare against the armed snapshot.  On growth: emit the
        ``health.recompile`` event (when obs is live), re-arm, and
        return the event dict -- or raise under action='raise'.
        Returns None when nothing new appeared.  Extra ``fields`` ride
        along in the event (the frontier stamps the step number)."""
        shapes = self.new_shapes()
        growth = self.cache_growth()
        if not shapes and growth <= 0:
            return None
        self.n_violations += 1
        parts = []
        if shapes:
            parts.append(f"{len(shapes)} new oracle shape(s): "
                         + ", ".join(f"{fam}[{rows}]"
                                     for fam, rows in shapes[:8])
                         + ("..." if len(shapes) > 8 else ""))
        if growth > 0:
            parts.append(f"{growth} new cache entr"
                         f"{'y' if growth == 1 else 'ies'} on watched "
                         "probes")
        msg = (f"unexpected recompilation in phase '{self.label}': "
               + "; ".join(parts))
        ev = {"kind": "event", "name": "health.recompile",
              "severity": "warn", "label": self.label,
              "value": len(shapes) + max(growth, 0),
              "shapes": [list(s) for s in shapes[:8]],
              "msg": msg, **fields}
        if self.obs is not None and getattr(self.obs, "enabled", False):
            emitted = self.obs.event(
                "health.recompile",
                **{k: v for k, v in ev.items()
                   if k not in ("kind", "name")})
            if emitted is not None:
                ev = emitted
        self.arm()  # report increments once, not once per step
        if self.action == "raise":
            raise RecompileError(msg)
        return ev

    # -- context manager ---------------------------------------------------

    def __enter__(self) -> "RecompileGuard":
        self.arm()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # Never mask an in-flight exception with the guard's own.
        if exc_type is None:
            self.check()
