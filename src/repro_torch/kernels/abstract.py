"""The hand-written kernels' abstract ("fake") implementations: their
outputs' shapes and dtypes, for tensors that hold no data.

The launch tools' dry-run runs a rank's step on fake tensors
(``FakeTensorMode``), on the CPU.  There a CPU tensor would take each
op's plain version -- attention materialising its [B, H, Sq, Sk] scores,
the scan looping over every time step -- which the card never runs.  A
fake (or meta) tensor takes these ops instead: each is a
``torch.library`` custom op whose fake implementation gives the kernel's
outputs (with the training outputs the backward reads: the row
log-sum-exp, the scan's chunk states), with a backward of the same kind.
``launch.hlo_analysis`` counts their FLOPs and bytes as the kernels do.
They never run on real tensors.
"""

from __future__ import annotations

import torch
from torch import Tensor

SCAN_CHUNK = 8  # the forward kernel keeps the state every 8 steps for the backward


def is_abstract(t) -> bool:
    """Whether ``t`` holds no data: a fake or meta tensor."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor) or (isinstance(t, Tensor) and t.is_meta)


def _refuse(name: str):
    raise RuntimeError(f"{name} is the abstract form of a kernel: it takes fake tensors only")


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool) -> Tensor:
    """The flash kernel: out [B, Hq, Sq, D] (under autograd the row
    log-sum-exp [B, Hq, Sq] f32 is kept too, as the forward kernel writes it)."""
    _refuse("repro_torch::flash_attention")


@flash_attention.register_fake
def _(q, k, v, causal):
    return q.new_empty(q.shape)


@torch.library.custom_op("repro_torch::flash_attention_lse", mutates_args=())
def flash_attention_lse(q: Tensor) -> Tensor:
    """The forward kernel's training output: each row's log-sum-exp."""
    _refuse("repro_torch::flash_attention_lse")


@flash_attention_lse.register_fake
def _(q):
    return q.new_empty(q.shape[:3], dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd(q: Tensor, k: Tensor, v: Tensor, out: Tensor, dout: Tensor,
                        lse: Tensor, causal: bool) -> tuple[Tensor, Tensor, Tensor]:
    """The flash backward kernel: (dq, dk, dv)."""
    _refuse("repro_torch::flash_attention_bwd")


@flash_attention_bwd.register_fake
def _(q, k, v, out, dout, lse, causal):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _flash_setup(ctx, inputs, output):
    q, k, v, causal = inputs
    ctx.save_for_backward(q, k, v, output, flash_attention_lse(q))
    ctx.causal = causal


def _flash_backward(ctx, dout):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, ctx.causal)
    return dq, dk, dv, None


flash_attention.register_autograd(_flash_backward, setup_context=_flash_setup)


@torch.library.custom_op("repro_torch::selective_scan", mutates_args=())
def selective_scan(dt: Tensor, bmat: Tensor, cmat: Tensor, x: Tensor, a: Tensor,
                   h0: Tensor) -> tuple[Tensor, Tensor]:
    """The scan kernel: (y [B, S, D], h_final [B, D, N]), f32."""
    _refuse("repro_torch::selective_scan")


@selective_scan.register_fake
def _(dt, bmat, cmat, x, a, h0):
    return dt.new_empty(dt.shape), h0.new_empty(h0.shape)


@torch.library.custom_op("repro_torch::selective_scan_states", mutates_args=())
def selective_scan_states(dt: Tensor, h0: Tensor) -> Tensor:
    """The forward kernel's training output: the state every 8 steps."""
    _refuse("repro_torch::selective_scan_states")


@selective_scan_states.register_fake
def _(dt, h0):
    b, s, d = dt.shape
    return h0.new_empty((b, -(-s // SCAN_CHUNK), d, h0.shape[-1]))


@torch.library.custom_op("repro_torch::selective_scan_bwd", mutates_args=())
def selective_scan_bwd(dt: Tensor, bmat: Tensor, cmat: Tensor, x: Tensor, a: Tensor,
                       h0: Tensor, dy: Tensor, states: Tensor
                       ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The scan backward kernel: (ddt, dB, dC, dx, dA, dh0)."""
    _refuse("repro_torch::selective_scan_bwd")


@selective_scan_bwd.register_fake
def _(dt, bmat, cmat, x, a, h0, dy, states):
    return tuple(t.new_empty(t.shape) for t in (dt, bmat, cmat, x, a, h0))


def _scan_setup(ctx, inputs, output):
    dt, bmat, cmat, x, a, h0 = inputs
    ctx.save_for_backward(*inputs, selective_scan_states(dt, h0))


def _scan_backward(ctx, dy, dh):
    *saved, states = ctx.saved_tensors
    if dy is None:
        dy = saved[0].new_zeros(saved[0].shape)
    return selective_scan_bwd(*saved, dy, states)


selective_scan.register_autograd(_scan_backward, setup_context=_scan_setup)


# FLOPs of the kernels' products, for launch.hlo_analysis (the scan's are
# element-wise: not counted, as no element-wise op is)
def _attention_pairs(q: Tensor, k: Tensor, causal: bool) -> int:
    sq, sk = q.shape[2], k.shape[2]
    if not causal or sq == 1:
        return sq * sk
    return sq * sk - sq * (sq - 1) // 2  # end-aligned causal rows


def flash_flops(q: Tensor, k: Tensor, causal: bool) -> float:
    """QK^T and PV over the live pairs: 4 B Hq pairs D."""
    return 4.0 * q.shape[0] * q.shape[1] * _attention_pairs(q, k, causal) * q.shape[3]


KERNEL_FLOPS = {
    "flash_attention": lambda q, k, v, causal: flash_flops(q, k, causal),
    # S and dP recomputed, then dV, dP... dQ, dK: five products over the pairs
    "flash_attention_bwd": lambda q, k, v, out, dout, lse, causal: 2.5 * flash_flops(
        q, k, causal),
}
