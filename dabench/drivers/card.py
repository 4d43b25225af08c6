"""The card's primitives that the drivers build on, in one place: timing
events, streams, pinned host buffers and graph capture."""

from __future__ import annotations

import torch


def event() -> torch.cuda.Event:
    """A timing event: it reads the card's clock."""
    return torch.cuda.Event(enable_timing=True)


def stream(device: torch.device) -> torch.cuda.Stream:
    return torch.cuda.Stream(device)


def use(s: torch.cuda.Stream):
    """A context in which work is enqueued on ``s``."""
    return torch.cuda.stream(s)


def host_buffer(shape) -> torch.Tensor:
    """A pinned int32 host buffer."""
    return torch.empty(shape, dtype=torch.int32, pin_memory=True)


def capture(fn, s: torch.cuda.Stream):
    """One call of ``fn`` captured as a CUDA graph on ``s``, as the
    serving engine captures it: ``replay()`` reruns it, ``output`` holds
    what it returns."""
    from repro_torch.kernels.graphs import capture as graph_capture

    return graph_capture(fn, stream=s)
