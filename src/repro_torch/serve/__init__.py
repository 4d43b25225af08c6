from .engine import Engine, Request

__all__ = ["Engine", "Request"]
