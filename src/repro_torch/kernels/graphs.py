"""CUDA graphs over the port's kernels, with their launches counted.

The JAX package jits its serving functions; the port's counterpart is a
CUDA graph: the eager body (many small launches, each a few microseconds
of host time) is captured once and replayed with one launch.  Each kernel
wrapper counts a launch where it launches its kernel.  Inside a capture
nothing runs, so the launches the captured body makes are tallied for
the graph instead (``_build.tally``), and every replay adds that tally to
the counters: a launch count reads the same whether the body ran eagerly
or was replayed.

Captures take one process-wide lock and run in ``"thread_local"`` error
mode, so other threads may keep launching on their own streams meanwhile
(the serve engine's shards do).  A capture waits only for its own
stream: unlike ``torch.cuda.graph``, it neither synchronises the device
nor empties the allocator's caches first, which would reach into other
threads' work.

A replay is traced as a host span ``graph.replay`` (it records no CUDA
event, so a loop of small replays is not slowed by it;
``repro_torch.obs.trace``).
"""

from __future__ import annotations

import threading
from collections.abc import Callable
from typing import Any

from ..obs import trace
from . import _build

_capture_lock = threading.Lock()


class CapturedGraph:
    """A captured CUDA graph, the output tensors its capture left behind
    (rewritten by each replay), and the kernel launches one replay makes."""

    def __init__(self, graph, output: Any, launches: dict[_build.LaunchCounter, int]):
        self.graph = graph
        self.output = output
        self.launches = launches

    def replay(self) -> None:
        """Launch the graph on the current stream and count its kernels'
        launches."""
        with trace.span("graph.replay"):
            self.graph.replay()
            for counter, n in self.launches.items():
                counter.add(n)

    def launches_by_kernel(self) -> dict[str, int]:
        """Kernel launches per replay, by counter name."""
        return {c.name: n for c, n in self.launches.items()}


def capture(fn: Callable[[], Any], stream=None, pool=None) -> CapturedGraph:
    """Capture one call of ``fn`` (no arguments: it reads and writes
    static tensors) into a CUDA graph on the current device.

    ``fn`` first runs once eagerly on the capture stream, which does the
    lazy set-up a capture may not (kernel libraries loaded, cuBLAS
    handles, shared-memory opt-ins); its launches are counted as usual.
    ``stream`` (a side stream, default a new one) carries the warm-up and
    the capture; ``pool`` is a ``torch.cuda.graph_pool_handle()`` shared
    by graphs that are never replayed concurrently."""
    import torch

    with _capture_lock:
        if stream is None:
            stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            fn()
            stream.synchronize()  # the warm-up is done before the capture starts
            with _build.tally() as launches:
                graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    output = fn()
                finally:
                    graph.capture_end()
        torch.cuda.current_stream(stream.device).wait_stream(stream)
    return CapturedGraph(graph, output, launches)
