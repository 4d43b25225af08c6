from .ops import draw

__all__ = ["draw"]
