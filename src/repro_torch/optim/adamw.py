"""AdamW with mixed-precision master params and optional 8-bit moments:
the port of the JAX package's ``repro.optim.adamw``.

Functional API, as there:
    init(params)                      -> AdamWState
    update(grads, state, params, lr)  -> (params, state)

Memory modes (RunConfig):
  master_dtype="float32"  classic mixed precision: f32 master copy,
                          bf16 working params; moments in f32.
  master_dtype=None       bf16 params are the master (no copy).
  state_dtype="int8"      blockwise-quantized moments (8-bit Adam).

Unlike the JAX function, ``update`` works in place to save memory: the
f32 moments, the master copy and the parameter tensors are overwritten
(int8 moments are replaced by newly quantized ones), and the returned
params are the tensors passed in.  Every operation is the reference's,
in its order and in f32, so the numbers are the same.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..tree import tree_leaves, tree_map
from .quantized_state import Quantized, dequantize, quantize


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar on the parameters' device
    m: Any
    v: Any
    master: Any  # f32 master params, or None


def _maybe_q(x, state_dtype, signed):
    if state_dtype == "int8":
        return quantize(x, signed)
    return x


def _maybe_dq(x):
    return dequantize(x) if isinstance(x, Quantized) else x


def _step_device(params) -> torch.device:
    """Where the step counter lives: beside the parameters (a plain
    tensor on a DTensor's device, the same on every rank)."""
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


def make_adamw(
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    master_dtype: str | None = "float32",
    state_dtype: str | None = None,
):
    def init(params):
        # zeros_like: a DTensor parameter's moments are laid out as it is
        zeros_m = tree_map(lambda p: _maybe_q(torch.zeros_like(p, dtype=torch.float32),
                                              state_dtype, True), params)
        zeros_v = tree_map(lambda p: _maybe_q(torch.zeros_like(p, dtype=torch.float32),
                                              state_dtype, False), params)
        master = (tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
                  if master_dtype == "float32" else None)
        step = torch.zeros((), dtype=torch.int32, device=_step_device(params))
        return AdamWState(step, zeros_m, zeros_v, master)

    def update(grads, state: AdamWState, params, lr):
        step = state.step + 1
        t = step.to(torch.float32)
        c1 = 1.0 - b1**t
        c2 = 1.0 - b2**t
        masters = state.master if state.master is not None else params

        @torch.no_grad()
        def upd(g, m_q, v_q, p, master):
            g = g.to(torch.float32)
            if isinstance(m_q, Quantized):
                m = dequantize(m_q) * b1 + (1 - b1) * g
                v = dequantize(v_q) * b2 + (1 - b2) * g * g
            else:  # f32 moments, updated in place
                m = m_q.mul_(b1).add_((1 - b1) * g)
                v = v_q.mul_(b2).add_((1 - b2) * g * g)
            mh = m / c1
            vh = v / c2
            master_f = master.to(torch.float32)
            new_master = master_f - lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * master_f)
            p.copy_(new_master)
            if master_dtype == "float32":
                master.copy_(new_master)
            return (_maybe_q(m, state_dtype, True), _maybe_q(v, state_dtype, False))

        out = tree_map(upd, grads, state.m, state.v, params, masters)
        # the pairs sit at the leaves of grads' structure
        new_m = tree_map(lambda _, o: o[0], grads, out)
        new_v = tree_map(lambda _, o: o[1], grads, out)
        return params, AdamWState(step, new_m, new_v, state.master)

    return init, update
