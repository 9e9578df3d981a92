"""Post-processing: reports from a built Tree and a RunLog stream
(post/analysis.py).  post/figures.py draws them with matplotlib and is
imported on its own, never from here: the package must import where
matplotlib is absent."""

from explicit_hybrid_mpc_tpu_torch.post.analysis import (  # noqa: F401
    load_runlog, partition_report, runtime_report)
