"""The serving engine's device leg, one batch at a time.

As ``runtime.engine._Shard.run_bucket`` does it: ``forward`` is captured
once on a static device input with ``repro_torch.kernels.graphs.capture``
on a side stream; then each batch is a ``non_blocking`` copy of the next
pinned host batch (from a pool of distinct ones) into the static input,
one replay, a copy of the output into pinned host memory, and a
synchronisation of the stream.  A batch's latency runs from the start of
its input copy to the end of its output copy, on the card's clock.
"""

from __future__ import annotations

import time

import torch

from . import Window, card


class Driver:
    def __init__(self, forward, config: dict, params: dict, device: torch.device, generator):
        self.forward = forward
        self.n = params["samples_per_call"]
        lo, hi = params["grid"]
        shape = (params["pool_calls"], self.n, *config["in_shape"])
        pool = torch.randint(lo, hi + 1, shape, dtype=torch.int32, device=device, generator=generator)
        self.pool = card.host_buffer(shape)
        self.pool.copy_(pool)
        del pool
        self.x = torch.zeros((self.n, *config["in_shape"]), dtype=torch.int32, device=device)
        self.y_host = card.host_buffer((self.n, *config["out_shape"]))
        self.start, self.end = card.event(), card.event()
        self.stream = card.stream(device)
        self.graph = None

    @property
    def samples_per_call(self) -> int:
        return self.n

    def inputs(self, k: int) -> torch.Tensor:
        return self.pool[k % self.pool.shape[0]]

    def warmup(self) -> None:
        self.graph = card.capture(lambda: self.forward(self.x), self.stream)
        self.run(0.0, lambda k, y: None, calls=3)

    def run(self, seconds: float, on_done, calls: int | None = None) -> Window:
        """Run batches for ``seconds`` (or exactly ``calls`` of them)."""
        win = Window()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        k = 0
        while (k < calls) if calls is not None else (time.perf_counter() < deadline):
            self._batch(k)
            win.latency_ms.append(self.start.elapsed_time(self.end))
            on_done(k, self.y_host)
            k += 1
        win.seconds = time.perf_counter() - t0
        win.attempted = win.completed = k
        win.samples = k * self.n
        return win

    def _batch(self, k: int) -> None:
        with card.use(self.stream):
            self.start.record(self.stream)
            self.x.copy_(self.inputs(k), non_blocking=True)
            self.graph.replay()
            self.y_host.copy_(self.graph.output, non_blocking=True)
            self.end.record(self.stream)
            self.stream.synchronize()
