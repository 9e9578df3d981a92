"""The port's operator tools, run as modules of the package:

- ``supervise_build``: run a build as a child process and restart it
  from its newest valid checkpoint generation until it finishes;
- ``chaos_suite``: the tier-1 build under five scripted fault schedules,
  each verdict held to a fault-free run;
- ``drift_smoke``: the rebuild service over a three-revision drift walk
  while a scheduler serves concurrent traffic;
- ``obs_report``: a report of an obs stream (or, ``--fleet``, of a
  process family's streams), diffed against a bench row that
  ``--bench`` names and an earlier stream that ``--drift`` names;
- ``obs_watch``: the health monitor over a live stream, exiting with
  its verdict;
- ``fleet_smoke``: a restart chain's (or, ``--sharded``, two shards')
  per-process streams reconciled bit-exactly with one process's build;
- ``preflight``: the pre-merge battery (lint, the tier-1 tests and the
  three smokes) with one verdict;
- ``precision_check``: the float32 leg's acceptance by the float64
  merit gate, and a mixed build against a float64 build;
- ``tune_schedule``: the IPM schedules' cost a QP and convergence, and
  the fastest that keeps the tree;
- ``onset_probe``: the satellite and quadrotor families built at a
  ladder of sub-box scales;
- ``long_build``: a checkpointed campaign resumed across sessions, with
  its progress rows, health halt and online figure;
- ``capture``: the helpers those four share (the JAX package's bench.py
  helpers of the same names);
- ``bench``: the JAX package's bench.py, its four modes (the flagship
  build's regions/s with its baselines, online and large-L figures; the
  warm rebuild; the drift walk; the sharded build), one JSON line a run;
- ``bench_history``: the bench's history row (scripts/bench_gate.py's
  format) in the port's own file;
- ``bench_gate``: the regression gate over that history (a row against
  the trailing window of rows of the same card and power limit);
- ``serve_bench``: the serving bench (scripts/serve_bench.py's sweeps);
- ``north_star``, ``bench_configs``, ``eps_ladder``,
  ``online_crossover``: the JAX package's remaining captures (the
  flagship with its serial parity, one row a configuration, an eps
  ladder, online µs a query against leaf count).

The builds, smokes, captures and the bench run on the CUDA device unless
``--backend cpu`` is given (for the captures and the bench also
``BENCH_PLATFORM=cpu``),
and refuse to start without a card otherwise; the report and
the watcher read streams and touch no device.
"""
