"""``python -m explicit_hybrid_mpc_tpu_torch.analysis``: the lint gate
(analysis/cli.py)."""

from explicit_hybrid_mpc_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
