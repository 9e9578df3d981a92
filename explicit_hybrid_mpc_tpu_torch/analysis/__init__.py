"""tpulint for the torch port: static + runtime analysis of
device-hostile code patterns.

The counterpart of the JAX package's ``analysis/``: the same rule ids,
pragma grammar, baseline schema and recompile-guard semantics, aimed at
eager torch on a CUDA card instead of jax tracing on a TPU.

- ``engine``  -- the AST rule engine: visitor framework, findings with
  file:line + rule id + severity, per-line and per-file
  ``# tpulint: disable=<rule>`` pragmas, JSON + human output, and the
  port's own checked-in ``analysis/baseline.json`` so known findings do
  not block the gate while NEW ones do (``python -m
  explicit_hybrid_mpc_tpu_torch.analysis`` is the CLI; it never touches
  the JAX package's baseline file).  Its device-region
  index is seeded by torch's compiled / captured wrappers and by the
  def-line pragma ``# tpulint: device-region``.
- ``rules``   -- host-sync-in-jit, recompile-hazard, dtype-discipline,
  obs-in-hot-loop, silent-except, in torch idiom.
- ``recompile_guard`` -- the runtime complement: snapshots the oracle's
  compiled-shape ledger (and/or ``_cache_size()`` probes such as
  ``kernels.loader``) around a build phase, raising or emitting a
  ``health.recompile`` event on growth (cfg.recompile_guard /
  ``--recompile-guard`` wires it into the frontier's steady-state wave
  loop).

The device regions.  The JAX index marks 83 functions in 13 modules
(the traced ones).  A port function carries ``# tpulint:
device-region`` where its counterpart is marked; the same-module
closure marks the helpers it calls.  Same-named counterparts:
``online/descent.py`` ``descend_from`` / ``evaluate_rows`` /
``locate_descent``; ``online/evaluator.py`` ``evaluate``;
``online/sharded.py`` ``_serve_shard``; ``online/pallas_eval.py``
``locate`` -> ``online/locate.py`` ``locate``; ``oracle/ipm.py``
``qp_solve`` / ``_run_leg`` / ``merit``; ``oracle/oracle.py``
``_solve_points_grid`` / ``reduce_deltas``; ``oracle/socp.py``'s
Jordan-algebra helpers and ``kkt_step``; ``oracle/pallas_ipm.py``
``_mv`` / ``_mtv`` / ``kkt_step`` -> ``oracle/ipm_leg.py``.
Differently named (JAX -> port):

- ``oracle/pallas_ipm.py`` kernel ``body`` / ``_chol_factor`` /
  ``_fwd_sub`` / ``_bwd_sub`` -> ``oracle/ipm_leg.py``
  ``ipm_leg_torch`` / ``chol_factor`` / ``fwd_sub`` / ``bwd_sub``, and
  the launch path -> ``ipm_leg`` / ``ipm_leg_cuda``;
- ``online/pallas_eval.py`` ``_locate_call`` / ``_locate_kernel`` ->
  ``online/locate.py`` ``locate_cuda`` / ``locate_torch`` (and
  ``evaluate``); ``arena_eval_fused`` / ``arena_eval_xla`` /
  ``_fused_call`` / ``_fused_kernel`` -> ``online/fused.py``
  ``arena_eval`` / ``arena_eval_cuda`` / ``arena_eval_torch``;
- ``serve/arena.py`` ``_eval_window`` -> ``online/fused.py``
  ``arena_eval`` (the port launches over the whole arena with a plan;
  ``DeviceArena.evaluate`` is host code around it, as in JAX);
- ``oracle/ipm.py`` ``_make_body`` / ``body`` / ``kkt_step`` /
  ``leg_constants`` / ``_fraction_to_boundary`` -> ``oracle/ipm_leg.py``
  ``ipm_leg_torch`` / ``kkt_step`` / ``leg_constants`` /
  ``fraction_to_boundary`` (the leg moved beside its kernel);
- ``oracle/oracle.py`` ``_solve_one`` / ``_solve_one_full`` ->
  ``_solve_pairs`` (+ ``point_qp``); ``_solve_points_all_deltas`` /
  ``_full`` / ``per_point`` -> ``_solve_points_grid``;
  ``_solve_simplex_min_one`` -> ``_solve_simplex_min`` (+
  ``simplex_min_qp``); ``_simplex_feas_one`` -> ``_simplex_feas`` (+
  ``simplex_feas_qp``); the jitted lambdas of ``Oracle.__init__`` ->
  the methods ``_solve_points``, ``_solve_pairs_ws``,
  ``_solve_pairs_p2``, ``_solve_fixed``, ``_solve_rescue``,
  ``_simplex_min``, ``_simplex_min_p2``, ``_simplex_feas``;
- ``oracle/prune.py``'s jitted lambdas -> ``PrunedOracle``
  ``_solve_pairs_red`` / ``_simplex_min_red`` / ``_point_feas_red``;
- ``oracle/soc_point.py`` ``solve_one`` (and its lambda) ->
  ``soc_pairs`` / ``SOCPointOracle._solve``;
- ``oracle/soc_oracle.py`` ``point_one`` / ``points_all`` ->
  ``SOCOracle._soc_pairs`` / ``_solve_points`` / ``_solve_fixed``;
- ``oracle/socp.py`` ``body`` (the fori_loop body) -> ``socp_solve``'s
  loop;
- ``parallel/mesh.py`` ``local`` -> ``sharded_grid_solver``'s ``fn``;
  ``staged`` (grid, replicated gather, reduction) -> ``fn``,
  ``MeshSolver._gather`` and ``reduce_deltas``;
- ``online/sharded.py``: ``_locate_shard`` (the locate-only program
  beside ``_serve_shard``).

No module in this package imports torch or numpy at module scope: the
engine is pure ``ast`` and the guard probes duck-typed objects
(``compiled_shapes`` ledgers, ``_cache_size()``), so lint cost is
parse-only and the guard adds no imports to the hot loop.
"""

from explicit_hybrid_mpc_tpu_torch.analysis.engine import (  # noqa: F401
    BASELINE_VERSION, Finding, Rule, baseline_payload, lint_paths,
    lint_source, load_baseline, split_baselined)
from explicit_hybrid_mpc_tpu_torch.analysis.recompile_guard import (  # noqa: F401
    RecompileError, RecompileGuard)
