"""GQA attention with optional qk-norm, RoPE and a head-major KV cache,
through the flash-attention op (the Hopper kernel on the card): causal
self-attention, full self-attention (the encoder's), and cross-attention
over an encoder's output (``kv_source``), whose K/V a decode step reads
from the cache that :func:`precompute_cross_cache` built at prefill.

Under active sharding rules the tensors are DTensors: q/k/v are laid out
by the reference's constraints (batch on the data dims, heads on
"model"), fresh K/V are replicated to the cache's heads
(``transformer.kv_cache_heads``), and the GQA head-sharding repair of
the reference repeats K/V to the full head count at prefill where the
KV heads do not divide the model axis.  The flash op then runs on each
rank's shard through ``local_map`` (:func:`_attend`): heads stay on
"model" where both the query and the KV heads divide it, else they are
replicated there.  A cache whose *sequence* dim is on "model" (no exact
head replication) is all-gathered along the sequence before the local
call: a local softmax over a key shard would be wrong (the reference's
GSPMD all-reduces the softmax statistics instead).
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..distributed import constrain
from ..distributed.sharding import axis_size, gathered, run_local
from ..kernels.flash_attention import flash_attention
from .layers import dense, rmsnorm, rope


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

    q = _heads(dense(x, gathered(p["wq"], None, "model")), hq, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
    if cross and cache is not None:
        # the precomputed cross cache: the JAX block also projects K/V of
        # kv_source here and discards them, so the port skips that product
        out = _attend(q.transpose(1, 2), cache["k"], cache["v"], causal=False)
        return _out_proj(p, out, b, s, hq * hd), cache

    src = x if kv_source is None else kv_source
    k = _heads(dense(src, gathered(p["wk"], None, "model")), hkv, hd)
    v = _heads(dense(src, gathered(p["wv"], None, "model")), hkv, hd)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"])
    if not cross:  # no RoPE on cross-attention
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    # prefill (s > 1, pos == 0) attends over the fresh K/V; decode over
    # the layer's cache, with the cache position as the query offset so
    # the unwritten slots beyond it stay masked
    new_cache = None
    if cache is not None:
        pos = cache["pos"]
        # the cache may hold KV heads replicated up to the model axis
        # (transformer.kv_cache_heads): replicate the fresh K/V to match
        h_eff = cache["k"].shape[1]
        kc, vc = k, v
        if h_eff != hkv:
            kc = k.repeat_interleave(h_eff // hkv, dim=2)
            vc = v.repeat_interleave(h_eff // hkv, dim=2)
        _dus_seq(cache["k"], kc.transpose(1, 2), pos)
        _dus_seq(cache["v"], vc.transpose(1, 2), pos)
        new_cache = {"k": cache["k"], "v": cache["v"], "pos": pos + s}
        if s == 1:
            out = _attend(q.transpose(1, 2), cache["k"], cache["v"], causal=causal and not cross,
                          offset=pos)
            return _out_proj(p, out, b, s, hq * hd), new_cache

    # GQA head-sharding repair (the reference's): where the query heads
    # divide the model axis and the KV heads do not, repeat K/V to the
    # full head count so attention stays head-parallel
    ms = axis_size("model")
    if s > 1 and hq != hkv and ms > 1 and hq % ms == 0 and hkv % ms != 0:
        k = constrain(k.repeat_interleave(hq // hkv, dim=2), "batch", "seq", "model", None)
        v = constrain(v.repeat_interleave(hq // hkv, dim=2), "batch", "seq", "model", None)
    out = _attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  causal=causal and not cross)
    return _out_proj(p, out, b, s, hq * hd), new_cache


def _heads(t, h: int, hd: int):
    """A projection [B, S, h*hd] as heads [B, S, h, hd], laid out by the
    reference's constraint (heads on "model" where h divides it; the
    projection's model shards are gathered first where it does not)."""
    if isinstance(t, DTensor) and h % axis_size("model"):
        t = constrain(t, "batch", "seq", None)
    return constrain(t.reshape(*t.shape[:2], h, hd), "batch", "seq", "model", None)


def _out_proj(p, out, b, s, width):
    """The attention output [B, H, S, hd] back to [B, S, H*hd], through ``wo``."""
    out = constrain(out.transpose(1, 2).reshape(b, s, width), "batch", "seq", "model")
    return constrain(dense(out, gathered(p["wo"], "model", None)), "batch", "seq", None)


def _attend(q, k, v, causal: bool, offset=None):
    """``flash_attention`` (q [B, Hq, Sq, hd], k/v [B, Hkv, Sk, hd]); on
    DTensors, on each rank's shard: batch where q has it, heads on
    "model" where both head counts divide it, sequences whole."""
    if not isinstance(q, DTensor):
        return flash_attention(q, k, v, causal=causal, offset=offset)
    mesh = q.device_mesh
    names = tuple(mesh.mesh_dim_names)
    heads_split = all(t.shape[1] % mesh.size(i) == 0 for t in (q, k)
                      for i, n in enumerate(names) if n == "model")
    pl = tuple(Shard(0) if p == Shard(0) else
               Shard(1) if n == "model" and heads_split else Replicate()
               for n, p in zip(names, q.placements))
    rep = tuple(Replicate() for _ in names)
    if isinstance(offset, torch.Tensor):
        return run_local(lambda q_, k_, v_, o_: flash_attention(q_, k_, v_, causal=causal,
                                                                offset=o_),
                         (q, k, v, offset), (pl, pl, pl, rep), pl, mesh)
    return run_local(lambda q_, k_, v_: flash_attention(q_, k_, v_, causal=causal, offset=offset),
                     (q, k, v), (pl, pl, pl), pl, mesh)


def precompute_cross_cache(cfg, p: dict, enc_out: torch.Tensor) -> dict:
    """K/V over the encoder output for decode-time cross-attention,
    head-major [B, Hkv, T, hd] (as the JAX function, without k-norm)."""
    hkv, hd = cfg.n_kv_heads, cfg.hd
    k = _heads(dense(enc_out, gathered(p["wk"], None, "model")), hkv, hd).transpose(1, 2)
    v = _heads(dense(enc_out, gathered(p["wv"], None, "model")), hkv, hd).transpose(1, 2)
    return {"k": k, "v": v}


def _dus_seq(buf: torch.Tensor, update: torch.Tensor, pos) -> None:
    """Write ``update`` [B, H, s, hd] into the head-major cache slice
    ``buf`` [B, H, S_max, hd] at sequence position ``pos``, in place.
    Like ``lax.dynamic_update_slice``, the start is clamped so the update
    fits.  ``pos`` may be an int or an int32 tensor on ``buf``'s device
    (read there, without a host sync).  On a DTensor cache every rank
    writes its own shard (:func:`_dus_seq_sharded`)."""
    if isinstance(buf, DTensor):
        _dus_seq_sharded(buf, update, pos)
        return
    s, s_max = update.shape[2], buf.shape[2]
    if isinstance(pos, torch.Tensor):
        start = pos.reshape(()).clamp(0, s_max - s).long()
        idx = start + torch.arange(s, device=buf.device)
        buf.index_copy_(2, idx, update.to(buf.dtype))
    else:
        start = min(max(int(pos), 0), s_max - s)
        buf[:, :, start : start + s] = update.to(buf.dtype)


def _dus_seq_sharded(buf, update, pos) -> None:
    """:func:`_dus_seq` on a DTensor cache: the update is laid out as the
    cache, but whole along the sequence, and each rank writes the part of
    it that falls in its own sequence shard (all of it where the sequence
    dim is not sharded)."""
    mesh = buf.device_mesh
    pl = tuple(Replicate() if p == Shard(2) else p for p in buf.placements)
    upd = update.redistribute(mesh, pl).to_local().to(buf.dtype)
    local = buf.to_local()
    s, s_max, s_loc = update.shape[2], buf.shape[2], local.shape[2]
    lo = 0  # the global sequence index of this rank's first cache slot
    for i, p in enumerate(buf.placements):
        if p == Shard(2):
            lo = lo * mesh.size(i) + mesh.get_local_rank(i)
    lo *= s_loc
    if isinstance(pos, DTensor):
        pos = pos.to_local()
    if isinstance(pos, torch.Tensor):
        start = pos.reshape(()).clamp(0, s_max - s).long()
        slots = lo + torch.arange(s_loc, device=local.device)  # [s_loc]
        rel = slots - start  # where each local slot falls in the update
        hit = (rel >= 0) & (rel < s)
        src = upd.index_select(2, rel.clamp(0, s - 1))
        local.copy_(torch.where(hit[:, None], src, local))
    else:
        start = min(max(int(pos), 0), s_max - s)
        a, b = max(start, lo), min(start + s, lo + s_loc)
        if a < b:
            local[:, :, a - lo : b - lo] = upd[:, :, a - start : b - start]
