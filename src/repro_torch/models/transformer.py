"""The LM stack of the dense and SSM families: embeddings, a stack of
pre-norm blocks (attention and SwiGLU for the dense family, a Mamba-1
mixer alone for the SSM family), final norm and head, with a decode
cache (head-major K/V, or the SSM's conv window and state) for prefill
and decode.

Parameters keep the JAX package's period-stacked layout: every leaf of a
block carries a leading ``n_periods`` dim, so a JAX parameter pytree
carries across leaf for leaf (:func:`params_from_numpy`).  A Python loop
over the periods takes the place of ``lax.scan``; remat, sharding and
abstract parameters have no counterpart on one device.  The MoE,
hybrid, encoder-decoder and VLM families are not ported yet (ROADMAP
Queue 1) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from ..configs.base import ATTN, MLP, SSM, ArchConfig
from .attention import attention_block
from .layers import embed_tokens, rmsnorm, swiglu, unembed
from .ssm import mamba_block

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class PSpec:
    """A parameter's shape and initialiser (the JAX package's ``PSpec``
    without its sharding axes, which mean nothing on one device)."""

    shape: tuple
    init: str = "normal"  # normal | embed | ones | zeros | ssm_a
    fan_in_axis: int | None = None  # for 1/sqrt(fan_in) scaling


_PORTED = {"dense": [(ATTN, MLP)], "ssm": [(SSM, None)]}  # family -> its one layer pattern


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is of the dense or the
    SSM family."""
    if cfg.n_experts or cfg.layer_pattern()[0] != _PORTED.get(cfg.family):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP Queue 1: "
            "MoE and hybrid families, then encoder-decoder and VLM); the port runs the "
            "dense and SSM families only"
        )


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ----------------------------------------------------------------------
# Parameter specs
# ----------------------------------------------------------------------
def _attn_specs(cfg: ArchConfig, periods: int) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = (periods,)
    s = {
        "wq": PSpec(p + (d, hq * hd), fan_in_axis=1),
        "wk": PSpec(p + (d, hkv * hd), fan_in_axis=1),
        "wv": PSpec(p + (d, hkv * hd), fan_in_axis=1),
        "wo": PSpec(p + (hq * hd, d), fan_in_axis=1),
    }
    if cfg.qk_norm:
        s["q_norm"] = PSpec(p + (hd,), "ones")
        s["k_norm"] = PSpec(p + (hd,), "ones")
    return s


def _mlp_specs(cfg: ArchConfig, periods: int) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    p = (periods,)
    return {
        "w_gate": PSpec(p + (d, f), fan_in_axis=1),
        "w_up": PSpec(p + (d, f), fan_in_axis=1),
        "w_down": PSpec(p + (f, d), fan_in_axis=1),
    }


def _ssm_specs(cfg: ArchConfig, periods: int) -> dict:
    d, di, st, k, dtr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv, cfg.dt_rank
    p = (periods,)
    return {
        "in_proj": PSpec(p + (d, 2 * di), fan_in_axis=1),
        "conv": PSpec(p + (di, k), fan_in_axis=2),
        "x_proj": PSpec(p + (di, dtr + 2 * st), fan_in_axis=1),
        "dt_proj": PSpec(p + (dtr, di), fan_in_axis=1),
        "dt_bias": PSpec(p + (di,), "zeros"),
        "a_log": PSpec(p + (di, st), "ssm_a"),
        "d": PSpec(p + (di,), "ones"),
        "out_proj": PSpec(p + (di, d), fan_in_axis=1),
    }


def _block_specs(cfg: ArchConfig, mixer: str, ffn: str | None, periods: int) -> dict:
    d = cfg.d_model
    p = (periods,)
    s: dict = {"norm1": PSpec(p + (d,), "ones")}
    if mixer == ATTN:
        s[ATTN] = _attn_specs(cfg, periods)
    else:
        s[SSM] = _ssm_specs(cfg, periods)
    if ffn is not None:  # a block without an FFN (the SSM family's) has no norm2
        s["norm2"] = PSpec(p + (d,), "ones")
        s[MLP] = _mlp_specs(cfg, periods)
    return s


def param_specs(cfg: ArchConfig) -> dict:
    check_supported(cfg)
    d, v = cfg.d_model, cfg.padded_vocab
    period, n_periods = cfg.layer_pattern()
    specs: dict = {
        "embed": PSpec((v, d), "embed"),
        "final_norm": PSpec((d,), "ones"),
        "blocks": [_block_specs(cfg, mixer, ffn, n_periods) for mixer, ffn in period],
    }
    if not cfg.tie_embeddings:
        specs["head"] = PSpec((d, v), fan_in_axis=0)
    return specs


def tree_map(fn, tree):
    """``fn`` over the leaves of a tree of dicts and lists (parameters,
    caches, specs)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _zip_specs(fn, specs, tree, path=""):
    """``fn(spec, leaf, path)`` over ``specs`` and a tree of the same structure."""
    if isinstance(specs, PSpec):
        return fn(specs, tree, path)
    if isinstance(specs, dict):
        if not isinstance(tree, dict) or set(tree) != set(specs):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"parameters at {path or '/'}: {got} != keys {sorted(specs)}")
        return {k: _zip_specs(fn, specs[k], tree[k], f"{path}/{k}") for k in specs}
    if not isinstance(tree, list | tuple) or len(tree) != len(specs):
        raise ValueError(f"parameters at {path}: expected a list of {len(specs)}")
    return [_zip_specs(fn, s, t, f"{path}/{i}") for i, (s, t) in enumerate(zip(specs, tree))]


# ----------------------------------------------------------------------
# Parameter materialisation
# ----------------------------------------------------------------------
def init_params(cfg: ArchConfig, generator: torch.Generator, device=None) -> dict:
    """Random parameters (normal, 1/sqrt(fan_in) or 0.02 for the
    embedding; ones for norms and the SSM's ``d``, zeros for ``dt_bias``,
    log(1..N) for ``a_log``) drawn in f32 from ``generator`` on its own
    device, then cast to ``cfg.dtype`` on ``device``.  A period-stacked
    block leaf is drawn one period slice at a time, so the f32 draw never
    holds a whole stack (falcon-mamba-7b's ``in_proj`` alone would be
    17 GB): pass a generator on the card to keep the draw off the host.
    The JAX package's ``init_params`` draws other numbers from the same
    seed: weights cross between the packages with :func:`params_from_numpy`."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)

    def make(spec: PSpec, stacked: bool) -> torch.Tensor:
        out = torch.empty(spec.shape, dtype=dtype, device=dev)
        if spec.init in ("ones", "zeros"):
            return out.fill_(1.0 if spec.init == "ones" else 0.0)
        if spec.init == "ssm_a":  # mamba: A_log = log(1..N), broadcast over d_inner
            st = spec.shape[-1]
            return out.copy_(torch.log(torch.arange(1, st + 1, dtype=torch.float32)))
        scale = 0.02 if spec.init == "embed" else 1.0
        if spec.fan_in_axis is not None:
            scale = 1.0 / math.sqrt(spec.shape[spec.fan_in_axis])
        for piece in (out if stacked else [out]):
            w = torch.randn(piece.shape, generator=generator, dtype=torch.float32,
                            device=generator.device)
            piece.copy_(w * scale)
        return out

    specs = param_specs(cfg)
    params = {k: make(v, False) for k, v in specs.items() if k != "blocks"}
    params["blocks"] = tree_map(lambda spec: make(spec, True), specs["blocks"])
    return params


def params_from_numpy(cfg: ArchConfig, tree, device=None) -> dict:
    """The port's parameters from a JAX parameter pytree given as nested
    dicts and lists of numpy arrays (bfloat16 arrays included), checked
    leaf by leaf against :func:`param_specs` and cast to ``cfg.dtype``."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)

    def convert(spec: PSpec, arr, path: str) -> torch.Tensor:
        arr = np.array(arr)  # a writable copy: JAX hands out read-only arrays
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"parameter {path}: shape {arr.shape} != {spec.shape}")
        if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
            t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(device=dev, dtype=dtype)

    return _zip_specs(convert, param_specs(cfg), tree)


def unflatten(flat) -> dict:
    """A nested tree from a mapping of ``"/"``-joined paths to leaves (the
    layout of a committed ``weights.npz``); a path part made of digits is
    a list index."""
    tree: dict = {}
    for path in flat:
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = flat[path]

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(tree)


# ----------------------------------------------------------------------
# Stack application
# ----------------------------------------------------------------------
def _apply_block(cfg, bp, mixer, ffn, x, positions, cache, pos):
    """One block; ``cache`` is this layer's slice, updated in place."""
    h = rmsnorm(x, bp["norm1"])
    if mixer == ATTN:
        attn_cache = None if cache is None else {"k": cache["k"], "v": cache["v"], "pos": pos}
        h, _ = attention_block(cfg, bp[ATTN], h, positions, attn_cache)
    else:
        h = mamba_block(cfg, bp[SSM], h, cache)
    x = x + h
    if ffn is not None:
        h = rmsnorm(x, bp["norm2"])
        m = bp[MLP]
        x = x + swiglu(h, m["w_gate"], m["w_up"], m["w_down"])
    return x


def _apply_stack(cfg, blocks, x, positions, caches=None, pos=None):
    """Run the layer stack, one period at a time.  ``blocks`` and
    ``caches``: one period-stacked tree per period position; the caches
    are updated in place."""
    pattern, n_periods = cfg.layer_pattern()
    for t in range(n_periods):
        for i, (mixer, ffn) in enumerate(pattern):
            bp = tree_map(lambda a, t=t: a[t], blocks[i])
            c = None if caches is None else tree_map(lambda a, t=t: a[t], caches[i])
            x = _apply_block(cfg, bp, mixer, ffn, x, positions, c, pos)
    return x


def _head(cfg, params, x):
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return unembed(x, head.to(x.dtype))


# ----------------------------------------------------------------------
# Public model functions
# ----------------------------------------------------------------------
def forward(cfg: ArchConfig, params: dict, batch: dict):
    """Training/prefill forward without a cache.  batch: tokens [B, S].
    Returns (logits [B, S, Vp], aux_loss), aux_loss 0 (no MoE is ported)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    x = embed_tokens(params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    x = _apply_stack(cfg, params["blocks"], x, positions)
    x = rmsnorm(x, params["final_norm"])
    return _head(cfg, params, x), torch.zeros((), dtype=torch.float32, device=x.device)


def kv_cache_heads(cfg: ArchConfig) -> int:
    """KV heads held in the cache: ``n_kv_heads`` on one device (the JAX
    package replicates them up to the tensor-parallel degree)."""
    return cfg.n_kv_heads


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device=None) -> dict:
    """Decode cache, zeroed: per period position, stacked over the periods,
    a head-major ``k``/``v`` of [n_periods, B, H, max_seq, hd] in
    ``cfg.dtype`` for attention, or the SSM's ``conv`` window [n_periods,
    B, k-1, d_inner] in ``cfg.dtype`` and state ``h`` [n_periods, B,
    d_inner, N] in f32; and ``pos``, an int32 scalar tensor on the device."""
    check_supported(cfg)
    dev = resolve_device(device)
    period, n_periods = cfg.layer_pattern()
    dtype = torch_dtype(cfg)

    def zeros(*shape, dt=dtype):
        return torch.zeros((n_periods, batch, *shape), dtype=dt, device=dev)

    blocks = []
    for mixer, _ in period:
        if mixer == ATTN:
            shp = (kv_cache_heads(cfg), max_seq, cfg.hd)
            blocks.append({"k": zeros(*shp), "v": zeros(*shp)})
        else:
            blocks.append({"conv": zeros(cfg.ssm_conv - 1, cfg.d_inner),
                           "h": zeros(cfg.d_inner, cfg.ssm_state, dt=torch.float32)})
    return {"blocks": blocks, "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def decode_step(cfg: ArchConfig, params: dict, tokens: torch.Tensor, cache: dict):
    """One-token decode. tokens: [B, 1].  Returns (logits [B, Vp], cache).
    The cache's tensors are written in place; the returned cache shares
    them and carries ``pos + 1``.  Nothing here syncs the host."""
    check_supported(cfg)
    x = embed_tokens(params["embed"], tokens)
    pos = cache["pos"]
    positions = pos.reshape(1, 1).expand(x.shape[0], 1)
    x = _apply_stack(cfg, params["blocks"], x, positions, caches=cache["blocks"], pos=pos)
    x = rmsnorm(x, params["final_norm"])
    logits = _head(cfg, params, x)[:, 0, :]
    return logits, {"blocks": cache["blocks"], "pos": pos + 1}


def prefill(cfg: ArchConfig, params: dict, batch: dict, max_seq: int):
    """Prefill: forward over the prompt, building the decode cache on the
    tokens' device.  Returns (logits of the last position [B, Vp], cache)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    if s > max_seq:
        raise ValueError(f"prefill length {s} exceeds cache size {max_seq}")
    cache = init_cache(cfg, b, max_seq, device=tokens.device)
    x = embed_tokens(params["embed"], tokens)
    positions = torch.arange(s, device=x.device)
    x = _apply_stack(cfg, params["blocks"], x, positions, caches=cache["blocks"], pos=0)
    x = rmsnorm(x, params["final_norm"])
    logits = _head(cfg, params, x[:, -1:, :])[:, 0, :]
    cache["pos"].fill_(s)
    return logits, cache
