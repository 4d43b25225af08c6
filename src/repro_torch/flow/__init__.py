"""Typed configs of the port (digest-compatible with ``repro.flow``)."""

from .config import CompileConfig, ConfigError, ServeConfig, SolverConfig

__all__ = ["CompileConfig", "ConfigError", "ServeConfig", "SolverConfig"]
