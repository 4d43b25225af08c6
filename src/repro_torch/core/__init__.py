"""Exact integer program representation (copy of what the port needs
from ``repro.core``; the CMVM solver itself stays on the JAX side)."""

from .dais import (
    KIND_ADD,
    KIND_INPUT,
    KIND_NEG,
    DAISProgram,
    Row,
    Term,
    qints_from_array,
    qints_to_array,
)
from .fixed_point import QInterval

__all__ = [
    "KIND_ADD",
    "KIND_INPUT",
    "KIND_NEG",
    "DAISProgram",
    "QInterval",
    "Row",
    "Term",
    "qints_from_array",
    "qints_to_array",
]
