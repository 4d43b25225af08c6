"""Deterministic fault injection for resilience testing (the port's copy
of the JAX package's ``chaos``).

See :mod:`repro_torch.chaos.plan` for the fault-site registry and plan
spec.  ``REPRO_CHAOS='{"seed": 7, "rules": [...]}'`` in the environment
installs a plan at import, in this package as in the JAX package.
"""

from .plan import (
    MODES,
    SITES,
    FaultInjectedError,
    FaultPlan,
    FaultRule,
    ThreadKillFault,
    active,
    fault_point,
    get_plan,
    io_fault,
    plan_from_spec,
    set_plan,
)

__all__ = [
    "MODES",
    "SITES",
    "FaultInjectedError",
    "FaultPlan",
    "FaultRule",
    "ThreadKillFault",
    "active",
    "fault_point",
    "get_plan",
    "io_fault",
    "plan_from_spec",
    "set_plan",
]
