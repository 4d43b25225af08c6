from .ops import quant_matmul

__all__ = ["quant_matmul"]
