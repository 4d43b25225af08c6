"""Plain PyTorch version of GQA attention (causal or full): the port of
the JAX package's ``attention_ref``, with its numerics.

Two paths, numerically identical:

  * dense: materialises the [B, H, Sq, Sk] logits; used for short
    sequences and at decode;
  * chunked: a Python loop over query chunks of ``_CHUNK`` rows, each
    attending only to its causal K prefix, when ``Sq * Sk > 2**24``.

GQA is a grouped product (query head ``h`` reads KV head
``h // (Hq // Hkv)``) without a K/V repeat.  Logits are f32 (operands
cast to f32, which is exact for bf16 and equals a bf16 x bf16 -> f32
product), masked with ``-inf`` and guarded by a ``-1e30`` floor on the
row max; ``p`` is cast to ``v``'s dtype before the PV product, which
accumulates in f32; the output takes ``q``'s dtype.  A query row that
sees no key (only possible with a negative offset) comes out NaN, as in
the reference.
"""

from __future__ import annotations

import torch

_DENSE_MAX_ELEMS = 1 << 24  # logits entries per (b, h) slice before chunking
_CHUNK = 1024


def _attend(q, k, v, scale, causal, q_start):
    """Grouped attention for one q chunk against k[:, :, :Sk'].

    q: [B, Hq, Cq, D]; k/v: [B, Hkv, Sk', D].  q_start: absolute position
    of q[0] (int or int32 tensor).  Masks key j > q_start + i.
    """
    b, hq, cq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    q5 = q.reshape(b, hkv, g, cq, d).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", q5, k.float()) * scale
    sk = k.shape[2]
    if causal:
        qi = torch.arange(cq, device=q.device)[:, None] + q_start
        ki = torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill(~(ki <= qi), float("-inf"))
    m = logits.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(logits - m)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    out = out / p.sum(dim=-1, keepdim=True)
    return out.reshape(b, hq, cq, d)


def attention_ref(
    q: torch.Tensor,  # [B, Hq, Sq, D]
    k: torch.Tensor,  # [B, Hkv, Sk, D]
    v: torch.Tensor,  # [B, Hkv, Sk, D]
    causal: bool = True,
    scale: float | None = None,
    offset=None,  # absolute position of q[0]; default end-aligned (Sk - Sq)
) -> torch.Tensor:
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    scale = d**-0.5 if scale is None else scale
    start = (sk - sq) if offset is None else offset

    if sq * sk <= _DENSE_MAX_ELEMS or sq == 1:
        return _attend(q, k, v, scale, causal, start).to(q.dtype)

    # chunked: causal chunks slice K to their live prefix, which needs the
    # offset on the host
    if causal and isinstance(start, torch.Tensor):
        raise ValueError("chunked causal attention needs an int offset")
    outs = []
    for i0 in range(0, sq, _CHUNK):
        cq = min(_CHUNK, sq - i0)
        if causal:
            hi = min(int(start) + i0 + cq, sk)
            hi = min(-(-hi // 128) * 128, sk)  # the reference's lane-aligned slices
        else:
            hi = sk
        outs.append(
            _attend(q[:, :, i0 : i0 + cq], k[:, :, :hi], v[:, :, :hi], scale, causal, start + i0)
        )
    return torch.cat(outs, dim=2).to(q.dtype)


def attention_lse_ref(q, k, causal: bool = True, scale: float | None = None, offset=None):
    """The plain row statistic the forward kernel stores for the backward:
    f32 [B, Hq, Sq], the log-sum-exp of each row's scaled, masked logits in
    base 2 (log2 of sum_j 2^(scale q.k_j log2 e)), +inf for a row that sees
    no key."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = d**-0.5 if scale is None else scale
    start = (sk - sq) if offset is None else offset
    logits = torch.einsum("bhgqd,bhkd->bhgqk", q.reshape(b, hkv, hq // hkv, sq, d).float(),
                          k.float()) * scale
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + start
        logits = logits.masked_fill(~(torch.arange(sk, device=q.device)[None, :] <= qi),
                                    float("-inf"))
    lse = torch.logsumexp(logits, dim=-1) * 1.4426950408889634
    return lse.masked_fill(lse == float("-inf"), float("inf")).reshape(b, hq, sq)


def attention_bwd_ref(q, k, v, dout, causal: bool = True, scale: float | None = None,
                      offset=None):
    """The plain backward: (dq, dk, dv) of ``attention_ref`` for the output
    gradient ``dout``, by autograd through it (dk and dv summed over each
    GQA group's query heads)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attention_ref(*leaves, causal=causal, scale=scale, offset=offset)
        return torch.autograd.grad(out, leaves, dout)
