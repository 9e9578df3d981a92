"""Nested span tracer with optional device-trace annotation passthrough.

``span("name")`` context managers nest per thread; each closed span
emits one ``kind="span"`` record to the sink with wall seconds, THREAD
CPU seconds (wall >> cpu means the span was blocked on a device
program or I/O -- the host/device split at a glance), its nesting
depth, and its parent span's name.

With ``device_annotations=True`` each span also opens a
``torch.profiler.record_function`` of the same name, so host spans
line up with CUDA kernels in a torch.profiler trace when a capture is
active (the obs='full' mode; see config.PartitionConfig.obs).
"""

from __future__ import annotations

import contextlib
import threading
import time


class Tracer:
    def __init__(self, sink=None, device_annotations: bool = False):
        self.sink = sink
        self._local = threading.local()
        self._annotation_cls = None
        if device_annotations:
            try:
                from torch.profiler import record_function
                self._annotation_cls = record_function
            except ImportError:  # torch without a profiler: host-only
                self._annotation_cls = None

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Trace one host region.  Yields the attrs dict so callers can
        attach fields computed inside the span (the frontier step span
        adds its region/leaf counts at exit); all attrs land flat on
        the emitted record."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        parent = stack[-1] if stack else None
        stack.append(name)
        ann = (self._annotation_cls(name) if self._annotation_cls
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        c0 = time.thread_time()
        try:
            with ann:
                yield attrs
        finally:
            stack.pop()
            if self.sink is not None:
                self.sink.emit(
                    "span", name,
                    wall_s=round(time.perf_counter() - t0, 6),
                    cpu_s=round(time.thread_time() - c0, 6),
                    depth=len(stack), parent=parent, **attrs)
