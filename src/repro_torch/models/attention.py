"""GQA self-attention with optional qk-norm, RoPE and a head-major KV
cache, through the flash-attention op (the Hopper kernel on the card).

The cross-attention path of the JAX package (``kv_source``,
``precompute_cross_cache``) is not ported yet (ROADMAP Queue 1, the
encoder-decoder family), nor is its mesh-only GQA head-sharding repair,
which never fires on one device.
"""

from __future__ import annotations

import torch

from ..kernels.flash_attention import flash_attention
from .layers import rmsnorm, rope


def attention_block(
    cfg,
    p: dict,
    x: torch.Tensor,  # [B, S, D]
    positions: torch.Tensor,  # [B, S] or [S]
    cache: dict | None = None,  # {"k", "v": [B, Hkv, S_max, hd], "pos": int or int32 tensor}
    causal: bool = True,
    kv_source: torch.Tensor | None = None,
):
    """Returns (out [B, S, D], new_cache).

    The cache is updated in place (the JAX version returns new buffers):
    ``new_cache`` holds the same ``k``/``v`` tensors, with ``pos`` moved
    on by ``S``.
    """
    if kv_source is not None:
        raise NotImplementedError(
            "cross-attention (kv_source) is not ported yet: ROADMAP Queue 1, "
            "the encoder-decoder family"
        )
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    q = (x @ p["wq"]).reshape(b, s, hq, hd)
    k = (x @ p["wk"]).reshape(b, s, hkv, hd)
    v = (x @ p["wv"]).reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    # prefill (s > 1, pos == 0) attends over the fresh K/V; decode over
    # the layer's cache, with the cache position as the query offset so
    # the unwritten slots beyond it stay masked
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)  # [B, Hkv, S, hd]
    offset = None
    new_cache = None
    if cache is not None:
        pos = cache["pos"]
        _dus_seq(cache["k"], kh, pos)
        _dus_seq(cache["v"], vh, pos)
        new_cache = {"k": cache["k"], "v": cache["v"], "pos": pos + s}
        if s == 1:
            kh, vh = cache["k"], cache["v"]
            offset = pos

    out = flash_attention(q.transpose(1, 2), kh, vh, causal=causal, offset=offset)
    out = out.transpose(1, 2).reshape(b, s, hq * hd)
    return out @ p["wo"], new_cache


def _dus_seq(buf: torch.Tensor, update: torch.Tensor, pos) -> None:
    """Write ``update`` [B, H, s, hd] into the head-major cache slice
    ``buf`` [B, H, S_max, hd] at sequence position ``pos``, in place.
    Like ``lax.dynamic_update_slice``, the start is clamped so the update
    fits.  ``pos`` may be an int or an int32 tensor on ``buf``'s device
    (read there, without a host sync)."""
    s, s_max = update.shape[2], buf.shape[2]
    if isinstance(pos, torch.Tensor):
        start = pos.reshape(()).clamp(0, s_max - s).long()
        idx = start + torch.arange(s, device=buf.device)
        buf.index_copy_(2, idx, update.to(buf.dtype))
    else:
        start = min(max(int(pos), 0), s_max - s)
        buf[:, :, start : start + s] = update.to(buf.dtype)
