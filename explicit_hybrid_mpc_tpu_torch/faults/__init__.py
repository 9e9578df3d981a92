"""Deterministic fault injection + bounded-recovery policy.

The robustness subsystem (docs/robustness.md): scripted fault
schedules (``plan.FaultPlan``) replayed through one-line hooks across
the oracle dispatch path, the pipelined frontier, checkpoint
save/load, the warm rebuild, and the serve registry
(``injector.fire``), plus the hardening the injections exercise --
retry/timeout/backoff with poison-cell quarantine (``policy``),
crash-safe atomic writes (utils/atomic.py), and the supervised-resume
loop (scripts/supervise_build.py, proven equivalent by
scripts/chaos_suite.py).
"""

from explicit_hybrid_mpc_tpu_torch.faults.injector import (  # noqa: F401
    ENV_PLAN, FaultInjector, activate, clear, current, fire, install,
    install_from_config)
from explicit_hybrid_mpc_tpu_torch.faults.plan import (  # noqa: F401
    FaultPlan, FaultSpec, InjectedCrash, InjectedFault)
from explicit_hybrid_mpc_tpu_torch.faults.policy import (  # noqa: F401
    RetryPolicy, SolveTimeout, call_with_timeout, synthesize_failure)
