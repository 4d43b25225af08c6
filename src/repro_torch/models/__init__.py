from .transformer import (
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    param_specs,
    params_from_numpy,
    prefill,
    unflatten,
)

__all__ = [
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "loss_fn",
    "param_specs",
    "params_from_numpy",
    "prefill",
    "unflatten",
]
