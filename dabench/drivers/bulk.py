"""Bulk emulation: one closed stream of large calls, dispatched ahead.

Each call is an eager ``forward`` on one device-resident chunk of a pool
of distinct chunks, followed by a copy of its outputs into pinned host
memory.  The host enqueues call k+1 before it waits for call k's
outputs, so ``in_flight`` calls are queued at once.  A call's latency
runs from its first enqueue (stamped on an idle side stream, which the
card reaches at once) to the end of its output copy, on the card's
clock: it includes the wait behind the call ahead.
"""

from __future__ import annotations

import time
from collections import deque

import torch

from . import Window, card


class Driver:
    def __init__(self, forward, config: dict, params: dict, device: torch.device, generator):
        self.forward = forward
        self.n = params["samples_per_call"]
        self.in_flight = params["in_flight"]
        lo, hi = params["grid"]
        # the whole pool in one draw, on the card, in the type the design takes
        self.pool = torch.randint(lo, hi + 1, (params["pool_calls"], self.n, *config["in_shape"]),
                                  dtype=torch.int32, device=device, generator=generator)
        self.host = [card.host_buffer((self.n, *config["out_shape"])) for _ in range(self.in_flight)]
        self.starts = [card.event() for _ in range(self.in_flight)]
        self.ends = [card.event() for _ in range(self.in_flight)]
        self.side = card.stream(device)

    @property
    def samples_per_call(self) -> int:
        return self.n

    def inputs(self, k: int) -> torch.Tensor:
        return self.pool[k % self.pool.shape[0]]

    def warmup(self) -> None:
        self.run(0.0, lambda k, y: None, calls=self.in_flight + 1)

    def run(self, seconds: float, on_done, calls: int | None = None) -> Window:
        """Issue calls for ``seconds`` (or exactly ``calls`` of them), then
        drain; returns the window."""
        win = Window()
        pending: deque = deque()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        k = 0
        while True:
            more = k < calls if calls is not None else time.perf_counter() < deadline
            if more:
                self._issue(k)
                pending.append(k)
                k += 1
            if pending and (len(pending) >= self.in_flight or not more):
                j = pending.popleft()
                slot = j % self.in_flight
                self.ends[slot].synchronize()
                # the start is on another stream: the end's completion does not imply it
                self.starts[slot].synchronize()
                win.latency_ms.append(self.starts[slot].elapsed_time(self.ends[slot]))
                on_done(j, self.host[slot])
                win.completed += 1
            elif not more:
                break
        win.seconds = time.perf_counter() - t0
        win.attempted = k
        win.samples = win.completed * self.n
        return win

    def _issue(self, k: int) -> None:
        slot = k % self.in_flight
        self.starts[slot].record(self.side)
        y = self.forward(self.inputs(k))
        self.host[slot].copy_(y, non_blocking=True)
        self.ends[slot].record()
