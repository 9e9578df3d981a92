"""Device resolution shared by every entry point of the port.

'cuda' (the default everywhere) means the first CUDA device and raises
when there is none: a build or an evaluation never carries on on the
CPU unless the caller asked for it with 'cpu'.
"""

from __future__ import annotations

import numpy as np
import torch


class NoCpuFallback(Exception):
    """Work that was asked to run on a CUDA device failed there, and the
    caller would have finished it on the CPU instead.  Not a
    RuntimeError, so no device-failure handler can swallow it."""


#: Exit code of a `main` process that ended with NoCpuFallback
#: (``main.cli``): a dead device, which no restart mends, so the build
#: supervisor (tools/supervise_build.py) does not restart such a child.
NO_CPU_FALLBACK_EXIT = 69


def resolve(device: "str | torch.device | None" = None) -> torch.device:
    """'cuda' / None -> cuda:0 (RuntimeError without a CUDA device);
    'cpu' -> cpu; a torch.device passes through, checked the same way."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was requested but torch.cuda.is_available() "
                "is False; pass backend/device 'cpu' to run on the CPU")
        return torch.device("cuda", 0 if dev.index is None else dev.index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")
    return dev


#: SMs that a kernel's launch plan assumes without a CUDA device at hand
#: (an H100 SXM's).
DEFAULT_SMS = 132


def sm_count(device) -> int:
    """The SMs of a CUDA `device`, DEFAULT_SMS for any other: what a
    kernel's launch plan is made for."""
    device = torch.device(device)
    if device.type != "cuda":
        return DEFAULT_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def to_device(a, device: torch.device,
              dtype: torch.dtype | None = None) -> torch.Tensor:
    """Host array -> tensor on `device` without blocking the host on the
    device queue: a CUDA copy goes through pinned memory and is issued
    non_blocking on the current stream (a pageable copy would wait for
    every kernel already queued -- the overlap the build pipeline
    depends on).  A CPU tensor is a private copy."""
    if device.type == "cuda":
        return torch.as_tensor(a, dtype=dtype).pin_memory().to(
            device, non_blocking=True)
    return torch.as_tensor(np.array(a, copy=True), dtype=dtype)
