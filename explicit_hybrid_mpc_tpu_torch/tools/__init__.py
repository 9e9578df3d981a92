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
  three smokes) with one verdict.

The builds and smokes run on the CUDA device unless ``--backend cpu``
is given, and refuse to start without a card otherwise; the report and
the watcher read streams and touch no device.
"""
