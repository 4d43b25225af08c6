"""GQA attention with optional qk-norm, RoPE and a head-major KV cache,
through the flash-attention op (the Hopper kernel on the card): causal
self-attention, full self-attention (the encoder's), and cross-attention
over an encoder's output (``kv_source``), whose K/V a decode step reads
from the cache that :func:`precompute_cross_cache` built at prefill.

The JAX package's mesh-only GQA head-sharding repair never fires on one
device and has no counterpart here.
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
    kv_source: torch.Tensor | None = None,  # [B, T, D]: cross-attention keys/values
):
    """Returns (out [B, S, D], new_cache).

    The self-attention cache is updated in place (the JAX version returns
    new buffers): ``new_cache`` holds the same ``k``/``v`` tensors, with
    ``pos`` moved on by ``S``.  With ``kv_source`` (cross-attention) no
    RoPE is applied and attention is full; given a ``cache``, it holds
    the precomputed cross K/V, which are read and not written."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cross = kv_source is not None

    q = (x @ p["wq"]).reshape(b, s, hq, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
    if cross and cache is not None:
        # the precomputed cross cache: the JAX block also projects K/V of
        # kv_source here and discards them, so the port skips that product
        out = flash_attention(q.transpose(1, 2), cache["k"], cache["v"], causal=False)
        return out.transpose(1, 2).reshape(b, s, hq * hd) @ p["wo"], cache

    src = x if kv_source is None else kv_source
    k = (src @ p["wk"]).reshape(b, src.shape[1], hkv, hd)
    v = (src @ p["wv"]).reshape(b, src.shape[1], hkv, hd)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"])
    if not cross:  # no RoPE on cross-attention
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

    out = flash_attention(q.transpose(1, 2), kh, vh, causal=causal and not cross, offset=offset)
    out = out.transpose(1, 2).reshape(b, s, hq * hd)
    return out @ p["wo"], new_cache


def precompute_cross_cache(cfg, p: dict, enc_out: torch.Tensor) -> dict:
    """K/V over the encoder output for decode-time cross-attention,
    head-major [B, Hkv, T, hd] (as the JAX function, without k-norm)."""
    b, t, _ = enc_out.shape
    hkv, hd = cfg.n_kv_heads, cfg.hd
    k = (enc_out @ p["wk"]).reshape(b, t, hkv, hd).transpose(1, 2)
    v = (enc_out @ p["wv"]).reshape(b, t, hkv, hd).transpose(1, 2)
    return {"k": k, "v": v}


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
