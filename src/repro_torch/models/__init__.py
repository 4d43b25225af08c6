from .transformer import (
    abstract_params,
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    param_shardings,
    param_specs,
    params_from_numpy,
    prefill,
    shard_params,
    unflatten,
)

__all__ = [
    "abstract_params",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "loss_fn",
    "param_shardings",
    "param_specs",
    "params_from_numpy",
    "prefill",
    "shard_params",
    "unflatten",
]
