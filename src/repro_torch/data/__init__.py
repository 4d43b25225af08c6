"""Training data: the deterministic, resumable token pipeline."""

from .pipeline import DataConfig, Pipeline

__all__ = ["DataConfig", "Pipeline"]
