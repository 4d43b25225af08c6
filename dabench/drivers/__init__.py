"""Traffic drivers, one module per kind: a traffic file's ``"driver"``
names the module, whose ``Driver`` class the harness builds.

A ``Driver(forward, config, params, device, generator)`` draws its inputs
from the generator in its constructor, warms up in ``warmup()``, and
measures in ``run(seconds, on_done)``: it calls ``on_done(k, y_host)``
with each call's outputs once they are in host memory and returns a
:class:`Window`.  ``inputs(k)`` gives call ``k``'s inputs again, for the
reference.  The card's primitives they use are those of ``card``.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Window:
    """One measured loop: calls issued and completed, samples completed,
    its length on the host clock, and each call's latency in ms."""

    seconds: float = 0.0
    attempted: int = 0
    completed: int = 0
    samples: int = 0
    latency_ms: list[float] = field(default_factory=list)
