"""The port's robustness gate, run as modules of the package:

- ``supervise_build``: run a build as a child process and restart it
  from its newest valid checkpoint generation until it finishes;
- ``chaos_suite``: the tier-1 build under five scripted fault schedules,
  each verdict held to a fault-free run;
- ``drift_smoke``: the rebuild service over a three-revision drift walk
  while a scheduler serves concurrent traffic.

Each runs on the CUDA device unless ``--backend cpu`` is given, and
refuses to start without a card otherwise.
"""
