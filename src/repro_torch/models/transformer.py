"""The LM stack of every family of the catalog: embeddings, a stack of
pre-norm blocks (attention and a SwiGLU FFN for the dense family,
attention and a top-k MoE FFN -- every ``moe_every``-th layer, dense
SwiGLU between -- for the MoE family, a Mamba-1 mixer alone for the SSM
family, Mamba and attention at 7:1 with MoE on odd layers for the hybrid
family), final norm and head, with a decode cache (head-major K/V, or
the SSM's conv window and state) for prefill and decode.  The
encoder-decoder family (whisper) adds an encoder over stub frame
embeddings (``enc_frames``) and a cross-attention sub-block in each
decoder block, whose K/V are computed once at prefill into the cache's
``cross``; the VLM family puts stub image embeddings (``img_embeds``)
before the tokens.

Parameters keep the JAX package's period-stacked layout: every leaf of a
block carries a leading ``n_periods`` dim, so a JAX parameter pytree
carries across leaf for leaf (:func:`params_from_numpy`).  A Python loop
over the periods takes the place of ``lax.scan``; ``cfg.remat`` becomes
``torch.utils.checkpoint`` around each period when a backward follows
(``loss_fn`` under autograd).

Sharding: :func:`param_shardings` and :func:`cache_shardings` resolve
each leaf's logical axes under :class:`~repro_torch.distributed.MeshRules`
to DTensor placements, :func:`shard_params` lays a tree out by them, and
under active rules (``use_rules``) the same functions run on DTensors,
with the reference's ``constrain`` calls as redistributions.
:func:`abstract_params` gives meta-device parameters, which allocate
nothing (the dry-run's stand-ins for ``ShapeDtypeStruct``).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor import zeros as dtensor_zeros
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from .._device import resolve_device
from ..configs.base import ATTN, MLP, MOE, SSM, ArchConfig
from ..distributed import MeshRules, constrain, current_rules, use_rules
from ..distributed.sharding import axis_size, like, run_local
from .. import random
from ..tree import tree_leaves, tree_map, tree_unflatten
from .attention import attention_block, precompute_cross_cache
from .layers import embed_tokens, rmsnorm, swiglu, unembed
from .moe import moe_block
from .ssm import mamba_block

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class PSpec:
    """A parameter's shape, logical sharding tokens (one per dim, resolved
    by :class:`~repro_torch.distributed.MeshRules`) and initialiser, as
    the JAX package's ``PSpec``."""

    shape: tuple
    axes: tuple  # logical sharding tokens per dim
    init: str = "normal"  # normal | embed | ones | zeros | ssm_a
    fan_in_axis: int | None = None  # for 1/sqrt(fan_in) scaling


FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` unless ``cfg`` is of one of the ``FAMILIES``."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}, not one of {FAMILIES}")


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ----------------------------------------------------------------------
# Parameter specs
# ----------------------------------------------------------------------
def _attn_specs(cfg: ArchConfig, periods: int) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = (periods,)
    s = {
        "wq": PSpec(p + (d, hq * hd), (None, "fsdp", "model"), fan_in_axis=1),
        "wk": PSpec(p + (d, hkv * hd), (None, "fsdp", "model"), fan_in_axis=1),
        "wv": PSpec(p + (d, hkv * hd), (None, "fsdp", "model"), fan_in_axis=1),
        "wo": PSpec(p + (hq * hd, d), (None, "model", "fsdp"), fan_in_axis=1),
    }
    if cfg.qk_norm:
        s["q_norm"] = PSpec(p + (hd,), (None, None), "ones")
        s["k_norm"] = PSpec(p + (hd,), (None, None), "ones")
    return s


def _mlp_specs(cfg: ArchConfig, periods: int) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    p = (periods,)
    return {
        "w_gate": PSpec(p + (d, f), (None, "fsdp", "model"), fan_in_axis=1),
        "w_up": PSpec(p + (d, f), (None, "fsdp", "model"), fan_in_axis=1),
        "w_down": PSpec(p + (f, d), (None, "model", "fsdp"), fan_in_axis=1),
    }


def _ssm_specs(cfg: ArchConfig, periods: int) -> dict:
    d, di, st, k, dtr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv, cfg.dt_rank
    p = (periods,)
    return {
        "in_proj": PSpec(p + (d, 2 * di), (None, "fsdp", "model"), fan_in_axis=1),
        "conv": PSpec(p + (di, k), (None, "model", None), fan_in_axis=2),
        "x_proj": PSpec(p + (di, dtr + 2 * st), (None, "model", None), fan_in_axis=1),
        "dt_proj": PSpec(p + (dtr, di), (None, None, "model"), fan_in_axis=1),
        "dt_bias": PSpec(p + (di,), (None, "model"), "zeros"),
        "a_log": PSpec(p + (di, st), (None, "model", None), "ssm_a"),
        "d": PSpec(p + (di,), (None, "model"), "ones"),
        "out_proj": PSpec(p + (di, d), (None, "model", "fsdp"), fan_in_axis=1),
    }


def _moe_specs(cfg: ArchConfig, periods: int) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = (periods,)
    return {
        "router": PSpec(p + (d, e), (None, "fsdp", None), fan_in_axis=1),
        "w_gate": PSpec(p + (e, d, f), (None, "model", "fsdp", None), fan_in_axis=2),
        "w_up": PSpec(p + (e, d, f), (None, "model", "fsdp", None), fan_in_axis=2),
        "w_down": PSpec(p + (e, f, d), (None, "model", None, "fsdp"), fan_in_axis=2),
    }


def _block_specs(cfg: ArchConfig, mixer: str, ffn: str | None, periods: int,
                 cross: bool = False) -> dict:
    d = cfg.d_model
    p = (periods,)
    s: dict = {"norm1": PSpec(p + (d,), (None, None), "ones")}
    if mixer == ATTN:
        s[ATTN] = _attn_specs(cfg, periods)
    else:
        s[SSM] = _ssm_specs(cfg, periods)
    if cross:  # an encoder-decoder's decoder block
        s["norm_x"] = PSpec(p + (d,), (None, None), "ones")
        s["cross"] = _attn_specs(cfg, periods)
    if ffn is not None:  # a block without an FFN (the SSM family's) has no norm2
        s["norm2"] = PSpec(p + (d,), (None, None), "ones")
        s[ffn] = _mlp_specs(cfg, periods) if ffn == MLP else _moe_specs(cfg, periods)
    return s


def param_specs(cfg: ArchConfig) -> dict:
    check_supported(cfg)
    d, v = cfg.d_model, cfg.padded_vocab
    period, n_periods = cfg.layer_pattern()
    cross = cfg.family == "encdec"
    specs: dict = {
        "embed": PSpec((v, d), ("model", "fsdp"), "embed"),
        "final_norm": PSpec((d,), (None,), "ones"),
        "blocks": [_block_specs(cfg, mixer, ffn, n_periods, cross) for mixer, ffn in period],
    }
    if not cfg.tie_embeddings:
        specs["head"] = PSpec((d, v), ("fsdp", "model"), fan_in_axis=0)
    if cross:
        specs["enc_blocks"] = [_block_specs(cfg, ATTN, MLP, cfg.encoder_layers)]
        specs["enc_final_norm"] = PSpec((d,), (None,), "ones")
    return specs


_STACKED = ("blocks", "enc_blocks")  # lists of period-stacked blocks


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
def _contiguous_strides(shape) -> tuple[int, ...]:
    strides, s = [], 1
    for n in reversed(shape):
        strides.append(s)
        s *= n
    return tuple(reversed(strides))


def init_scale(spec: PSpec) -> float:
    """The factor of a normal leaf's draw: 1/sqrt(fan_in) where the spec
    names its fan-in axis, else 0.02 for the embedding and 1."""
    if spec.fan_in_axis is not None:
        return 1.0 / math.sqrt(spec.shape[spec.fan_in_axis])
    return 0.02 if spec.init == "embed" else 1.0


def init_launches(cfg: ArchConfig) -> int:
    """The draws one :func:`init_params` of ``cfg`` makes (kernel launches
    on the card): one a normal leaf, one a period slice of a stacked one."""
    return sum(spec.shape[0] if k in _STACKED else 1
               for k, sub in param_specs(cfg).items() for spec in tree_leaves(sub)
               if spec.init in ("normal", "embed"))


def init_params(cfg: ArchConfig, key, device=None, shardings=None) -> dict:
    """The JAX package's parameters of ``cfg`` from ``key``
    (``repro_torch.random.PRNGKey(seed)``): one key per leaf by
    ``random.split(key, n_leaves)`` in JAX's flatten order; a normal leaf
    is ``normal(leaf_key, shape) * scale`` in f32 (1/sqrt(fan_in), or
    0.02 for the embedding) cast to ``cfg.dtype``; ones for norms and the
    SSM's ``d``, zeros for ``dt_bias``, log(1..N) for ``a_log``.  The draw
    runs on ``device`` (the kernel on the card), each element from its
    leaf's key and its global index alone, so any block of a leaf is drawn
    on its own with the whole leaf's values there.  A period-stacked block
    leaf is drawn one period slice at a time.

    With ``shardings`` (:func:`param_shardings`), each leaf is this rank's
    block only, as a DTensor: no rank holds a whole leaf and nothing is
    communicated (the reference's ``jit`` with ``out_shardings``).
    ``device="meta"`` gives the same tensors without storage."""
    if isinstance(key, torch.Generator):
        raise TypeError("init_params takes a key, repro_torch.random.PRNGKey(seed), "
                        "not a torch.Generator")
    dev = torch.device("meta") if device == "meta" else resolve_device(device)
    dtype = torch_dtype(cfg)
    specs = param_specs(cfg)
    keys = tree_unflatten(specs, random.split(key, len(tree_leaves(specs))))
    if shardings is None:
        shardings = tree_map(lambda _: None, specs)

    draws = []  # (out, key, shape, offset, scale) of every normal leaf, drawn at the end

    def make(spec: PSpec, leaf_key, sharding, *, stacked: bool) -> torch.Tensor:
        if sharding is None:
            block, offset = tuple(spec.shape), (0,) * len(spec.shape)
        else:
            block, offset = compute_local_shape_and_global_offset(
                spec.shape, sharding[0], list(sharding[1]))
        out = torch.empty(block, dtype=dtype, device=dev)
        if spec.init in ("ones", "zeros"):
            out.fill_(1.0 if spec.init == "ones" else 0.0)
        elif spec.init == "ssm_a":  # mamba: A_log = log(1..N), broadcast over d_inner
            n = torch.arange(offset[-1] + 1, offset[-1] + block[-1] + 1, dtype=torch.float32)
            out.copy_(torch.log(n))
        else:
            scale = init_scale(spec)
            if stacked:
                draws.extend((out[p:p + 1], leaf_key, spec.shape, (offset[0] + p, *offset[1:]),
                              scale) for p in range(block[0]))
            else:
                draws.append((out, leaf_key, spec.shape, offset, scale))
        if sharding is None:
            return out
        mesh, placements = sharding
        return DTensor.from_local(out, mesh, list(placements), run_check=False,
                                  shape=torch.Size(spec.shape),
                                  stride=_contiguous_strides(spec.shape))

    params = {k: tree_map(functools.partial(make, stacked=k in _STACKED), specs[k], keys[k],
                          shardings[k])
              for k in specs}
    random.normal_many(draws)  # into the local tensors the DTensors wrap
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


def _map_specs(fn, cfg: ArchConfig) -> dict:
    """``fn(spec)`` over every leaf of :func:`param_specs`."""
    return tree_map(fn, param_specs(cfg))


def abstract_params(cfg: ArchConfig) -> dict:
    """Parameters as meta-device tensors of ``cfg.dtype``: shapes and
    dtypes, no storage (the reference's ``ShapeDtypeStruct`` tree)."""
    dtype = torch_dtype(cfg)
    return _map_specs(lambda spec: torch.empty(spec.shape, dtype=dtype, device="meta"), cfg)


def param_shardings(cfg: ArchConfig, rules: MeshRules) -> dict:
    """Each parameter's (mesh, placements) under ``rules``."""
    return _map_specs(lambda spec: rules.sharding(spec.axes, spec.shape), cfg)


def shard_params(params, shardings):
    """Lay a tree of tensors out by a tree of (mesh, placements) of the
    same structure (:func:`param_shardings`, or a state's): a plain leaf
    -- the same on every rank -- is distributed, a DTensor leaf
    redistributed.  The reference's ``jax.device_put(params, shardings)``."""
    def place(x, sh):
        mesh, placements = sh
        if isinstance(x, DTensor):
            return x.redistribute(mesh, placements)
        return distribute_tensor(x, mesh, list(placements), src_data_rank=None)

    return tree_map(place, params, shardings)


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
def _apply_block(cfg, bp, mixer, ffn, x, positions, cache, pos, causal=True, enc_out=None,
                 cross_cache=None):
    """One block; ``cache`` is this layer's slice, updated in place, and
    ``cross_cache`` its precomputed cross K/V (read only).  Returns (x,
    the MoE aux loss or None)."""
    aux = None
    h = rmsnorm(x, bp["norm1"])
    if mixer == ATTN:
        attn_cache = None if cache is None else {"k": cache["k"], "v": cache["v"], "pos": pos}
        h, _ = attention_block(cfg, bp[ATTN], h, positions, attn_cache, causal)
    else:
        h = mamba_block(cfg, bp[SSM], h, cache)
    x = x + h
    if enc_out is not None or cross_cache is not None:
        h = rmsnorm(x, bp["norm_x"])
        if cross_cache is None:
            h, _ = attention_block(cfg, bp["cross"], h, positions, None, False, enc_out)
        else:  # K/V from the cross cache; kv_source only flags the cross path
            h, _ = attention_block(cfg, bp["cross"], h, positions, cross_cache, False, h)
        x = x + h
    if ffn == MLP:
        h = rmsnorm(x, bp["norm2"])
        m = bp[MLP]
        x = x + swiglu(h, m["w_gate"], m["w_up"], m["w_down"])
    elif ffn == MOE:
        h, aux = moe_block(cfg, bp[MOE], rmsnorm(x, bp["norm2"]))
        x = x + h
    return constrain(x, "batch", "seq", None), aux


def _apply_stack(cfg, blocks, pattern, x, positions, caches=None, pos=None, causal=True,
                 enc_out=None, cross_caches=None):
    """Run the layer stack of ``pattern`` (one period of (mixer, ffn)),
    one period at a time.  ``blocks``, ``caches`` and ``cross_caches``:
    one period-stacked tree per period position; the caches are updated
    in place.  Returns (x, the summed MoE aux loss, f32)."""
    n_periods = blocks[0]["norm1"].shape[0]
    aux = like(torch.zeros((), dtype=torch.float32, device=x.device), x)

    def period(t, x, aux):
        for i, (mixer, ffn) in enumerate(pattern):
            bp, c, cc = (None if tree is None else tree_map(lambda a: a[t], tree[i])
                         for tree in (blocks, caches, cross_caches))
            x, a = _apply_block(cfg, bp, mixer, ffn, x, positions, c, pos, causal, enc_out, cc)
            if a is not None:
                aux = aux + a
        return x, aux

    # remat applies where a backward will follow: no cache is written
    remat = cfg.remat if caches is None and torch.is_grad_enabled() else "none"
    for t in range(n_periods):
        x, aux = _remat(remat, period, t, x, aux)
    return x, aux


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of plain matrix products
    (``x @ w``: ``mm``/``addmm``, as JAX's
    ``dots_with_no_batch_dims_saveable`` keeps dots without batch dims),
    recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(remat: str, fn, *args):
    """``fn(*args)`` under ``cfg.remat``: ``"none"`` keeps every
    activation for the backward; ``"full"`` keeps only the inputs of the
    period and recomputes it in the backward; ``"dots"`` keeps the matrix
    products' outputs too.  Remat changes memory, never a number."""
    if remat == "none":
        return fn(*args)
    if remat == "dots":
        context = functools.partial(create_selective_checkpoint_contexts, _save_dots)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=context)
    if remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    raise ValueError(f"unknown remat {remat!r}: not one of full, dots, none")


def _encode(cfg, params, enc_frames):
    """The whisper-style encoder over stub frame embeddings [B, T, D]:
    full self-attention blocks, then the encoder's final norm."""
    x = constrain(enc_frames, "batch", "seq", None)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = _apply_stack(cfg, params["enc_blocks"], [(ATTN, MLP)], x, positions, causal=False)
    return rmsnorm(x, params["enc_final_norm"])


def _build_cross_caches(cfg, params, enc_out, out):
    """Write the cross-attention K/V of every decoder block over the
    encoder output [B, encoder_seq, D] into ``out``, a cache's ``cross``
    (per period position, [n_periods, B, Hkv, encoder_seq, hd]): the same
    tensors, which a captured decode step reads."""
    for bp, cc in zip(params["blocks"], out):
        for t in range(bp["norm1"].shape[0]):
            new = precompute_cross_cache(cfg, {k: w[t] for k, w in bp["cross"].items()}, enc_out)
            if new["k"].shape != cc["k"][t].shape:
                raise ValueError(f"encoder output {tuple(enc_out.shape)} does not fit the cross "
                                 f"cache {tuple(cc['k'].shape)} (encoder_seq {cfg.encoder_seq})")
            cc["k"][t].copy_(new["k"])
            cc["v"][t].copy_(new["v"])


def _head(cfg, params, x):
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return unembed(x, head.to(x.dtype))


# ----------------------------------------------------------------------
# Public model functions
# ----------------------------------------------------------------------
def _embed_inputs(cfg, params, batch):
    """The token embeddings, after the VLM's image embeddings (cast to
    their dtype) where the family has them, and the encoder's output for
    an encoder-decoder (else None).  Returns (x, n_img, enc_out)."""
    x = embed_tokens(params["embed"], batch["tokens"])
    n_img = 0
    if cfg.family == "vlm":
        img = batch["img_embeds"].to(x.dtype)  # [B, vt, D] (frontend stub)
        x = torch.cat([img, x], dim=1)
        n_img = img.shape[1]
    enc_out = None
    if cfg.family == "encdec":
        enc_out = _encode(cfg, params, batch["enc_frames"].to(x.dtype))
    return x, n_img, enc_out


def forward(cfg: ArchConfig, params: dict, batch: dict):
    """Training/prefill forward without a cache.  batch: tokens [B, S],
    and ``enc_frames`` [B, T, D] (encoder-decoder) or ``img_embeds`` [B,
    vt, D] (VLM).  Returns (logits [B, S, Vp] of the text positions,
    aux_loss): the MoE layers' summed Switch load-balance loss (f32; 0
    without MoE layers)."""
    check_supported(cfg)
    x, n_img, enc_out = _embed_inputs(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    pattern, _ = cfg.layer_pattern()
    x, aux = _apply_stack(cfg, params["blocks"], pattern, x, positions, enc_out=enc_out)
    x = rmsnorm(x, params["final_norm"])
    return _head(cfg, params, x[:, n_img:, :]), aux


def loss_fn(cfg: ArchConfig, params: dict, batch: dict):
    """Next-token cross-entropy in f32 (labels of -1 are masked), plus
    0.01 times the MoE aux loss.  Returns (loss, {"nll", "aux"}); the
    port of the JAX package's ``loss_fn``."""
    logits, aux = forward(cfg, params, batch)
    labels = batch["labels"]
    mask = labels >= 0
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    if isinstance(logits, DTensor):
        # each row over the whole vocabulary (gathered from "model"), on
        # each rank's rows: the same sums as unsharded, the gradient whole
        logits = constrain(logits, "batch", None, None)
        rows = tuple(logits.placements)
        nll = run_local(_token_nll, (logits, safe), (rows, rows[:]), rows, logits.device_mesh,
                        in_grad_placements=(rows, rows)) * mask
    else:
        nll = _token_nll(logits, safe) * mask
    # scalars replicated on every rank (a sum over the batch shards is partial)
    loss = constrain(nll.sum() / mask.sum().clamp_min(1))
    aux = constrain(aux)
    return loss + 0.01 * aux, {"nll": loss, "aux": aux}


def _token_nll(logits, labels):
    """Each token's log-sum-exp of its f32 logits less its label's logit."""
    logits = logits.float()
    return torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels[..., None])[..., 0]


def kv_cache_heads(cfg: ArchConfig) -> int:
    """KV heads held in the cache: replicated up to the smallest multiple
    that the model axis divides (the classic GQA/MQA tensor-parallel
    serving trick -- vLLM does the same).  Exact: query head q reads
    replicated head (q * H_eff) // H_q == q // group.  Without it, an
    H_kv < model_parallelism cache must shard its sequence dim.  With no
    rules active (one device) it is ``n_kv_heads``."""
    hkv = cfg.n_kv_heads
    ms = max(axis_size("model"), 1)
    if hkv == 0 or hkv % ms == 0 or cfg.n_heads % ms != 0:
        return hkv
    r = 1
    while (hkv * r) % ms or (cfg.n_heads % (hkv * r)):
        r += 1
        if hkv * r > cfg.n_heads:
            return hkv  # no exact replication factor; keep seq sharding
    return hkv * r


def _cache_shapes(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """The decode cache's tree of (shape, dtype) leaves."""
    period, n_periods = cfg.layer_pattern()
    dtype = torch_dtype(cfg)
    blocks = []
    for mixer, _ in period:
        if mixer == ATTN:
            shp = ((n_periods, batch, kv_cache_heads(cfg), max_seq, cfg.hd), dtype)
            blocks.append({"k": shp, "v": shp})
        else:
            blocks.append({"conv": ((n_periods, batch, cfg.ssm_conv - 1, cfg.d_inner), dtype),
                           "h": ((n_periods, batch, cfg.d_inner, cfg.ssm_state), torch.float32)})
    cache = {"blocks": blocks, "pos": ((), torch.int32)}
    if cfg.family == "encdec":
        shp = ((n_periods, batch, cfg.n_kv_heads, cfg.encoder_seq, cfg.hd), dtype)
        cache["cross"] = [{"k": shp, "v": shp}]
    return cache


def _is_shape_leaf(v) -> bool:
    return isinstance(v, tuple) and len(v) == 2 and isinstance(v[1], torch.dtype)


def _map_cache(fn, tree):
    if _is_shape_leaf(tree):
        return fn(*tree)
    if isinstance(tree, dict):
        return {k: _map_cache(fn, v) for k, v in tree.items()}
    return [_map_cache(fn, v) for v in tree]


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device=None,
               abstract: bool = False) -> dict:
    """Decode cache, zeroed: per period position, stacked over the periods,
    a head-major ``k``/``v`` of [n_periods, B, H, max_seq, hd] in
    ``cfg.dtype`` for attention (H = :func:`kv_cache_heads`), or the SSM's
    ``conv`` window [n_periods, B, k-1, d_inner] in ``cfg.dtype`` and
    state ``h`` [n_periods, B, d_inner, N] in f32; ``pos``, an int32
    scalar tensor on the device; and for an encoder-decoder ``cross``, the
    cross-attention K/V of [n_periods, B, H, encoder_seq, hd], filled by
    prefill.  Under active rules every leaf is a DTensor laid out by
    :func:`cache_shardings` on the rules' mesh (``device`` is not read),
    each rank allocating only its shard.  With ``abstract`` the leaves
    are meta-device tensors, which allocate nothing."""
    check_supported(cfg)
    shapes = _cache_shapes(cfg, batch, max_seq)
    if abstract:
        return _map_cache(lambda shape, dt: torch.empty(shape, dtype=dt, device="meta"), shapes)
    rules = current_rules()
    if rules is not None:
        def make(shape, dt, sh):
            return dtensor_zeros(shape, dtype=dt, device_mesh=sh[0], placements=list(sh[1]))

        return _zip_cache(make, shapes, cache_shardings(cfg, rules, batch, max_seq))
    dev = resolve_device(device)
    return _map_cache(lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev), shapes)


def _zip_cache(fn, shapes, shardings):
    if _is_shape_leaf(shapes):
        return fn(*shapes, shardings)
    if isinstance(shapes, dict):
        return {k: _zip_cache(fn, v, shardings[k]) for k, v in shapes.items()}
    return [_zip_cache(fn, v, w) for v, w in zip(shapes, shardings)]


def cache_shardings(cfg: ArchConfig, rules: MeshRules, batch: int, max_seq: int) -> dict:
    """KV caches: batch on the data axes; the model axis takes kv heads
    when they divide it, otherwise the cache *sequence* dim (which the
    port's decode all-gathers before attention).  SSM caches: d_inner on
    the model axis where it divides it, else the last dim."""
    model_size = rules._axis_size(rules.axes_for("model"))

    def shard(shape, _dtype):
        if len(shape) == 5:  # attention KV: [P, B, H, S, hd] (head-major)
            if model_size and shape[2] % max(model_size, 1) == 0:
                axes = (None, "batch", "model", None, None)
            else:
                axes = (None, "batch", None, "model", None)
            return rules.sharding(axes, shape)
        if len(shape) == 4:  # ssm: [P, B, k-1, d_inner] or [P, B, d_inner, st]
            if shape[2] % max(model_size, 1) == 0 and shape[2] >= model_size:
                axes = (None, "batch", "model", None)
            else:
                axes = (None, "batch", None, "model")
            return rules.sharding(axes, shape)
        return rules.sharding((None,) * len(shape), shape)

    with use_rules(rules):  # the cache's heads as replicated under these rules
        return _map_cache(shard, _cache_shapes(cfg, batch, max_seq))


def decode_step(cfg: ArchConfig, params: dict, tokens: torch.Tensor, cache: dict):
    """One-token decode. tokens: [B, 1].  Returns (logits [B, Vp], cache).
    The cache's tensors are written in place (the cross cache is only
    read); the returned cache shares them and carries ``pos + 1``.
    Nothing here syncs the host."""
    check_supported(cfg)
    x = embed_tokens(params["embed"], tokens)
    pos = cache["pos"]
    positions = pos.reshape(1, 1).expand(x.shape[0], 1)
    pattern, _ = cfg.layer_pattern()
    cross = cache.get("cross")
    x, _ = _apply_stack(cfg, params["blocks"], pattern, x, positions, caches=cache["blocks"],
                        pos=pos, cross_caches=cross)
    x = rmsnorm(x, params["final_norm"])
    logits = _head(cfg, params, x)[:, 0, :]
    return logits, {**cache, "pos": pos + 1}


def prefill(cfg: ArchConfig, params: dict, batch: dict, max_seq: int, cache: dict | None = None):
    """Prefill: forward over the prompt (after the VLM's image embeddings;
    an encoder-decoder first runs its encoder and fills the cross cache),
    building the decode cache on the tokens' device.  Returns (logits of
    the last position [B, Vp], cache).  ``cache``, where given (one of
    ``init_cache(cfg, B, max_seq)``), is written in place instead of a new
    one, its self-attention and SSM entries zeroed first: the serving
    engine keeps one static cache, cross K/V included, for its decode
    graph."""
    check_supported(cfg)
    x, _, enc_out = _embed_inputs(cfg, params, batch)
    b, s = x.shape[:2]
    if s > max_seq:
        raise ValueError(f"prefill length {s} (vision tokens included) exceeds cache size "
                         f"{max_seq}")
    if cache is None:
        cache = init_cache(cfg, b, max_seq, device=x.device)
    else:
        tree_map(lambda t: t.zero_(), cache["blocks"])
    if enc_out is not None:
        _build_cross_caches(cfg, params, enc_out, cache["cross"])
    positions = torch.arange(s, device=x.device)
    pattern, _ = cfg.layer_pattern()
    x, _ = _apply_stack(cfg, params["blocks"], pattern, x, positions, caches=cache["blocks"],
                        pos=0, enc_out=enc_out, cross_caches=cache.get("cross"))
    x = rmsnorm(x, params["final_norm"])
    logits = _head(cfg, params, x[:, -1:, :])[:, 0, :]
    cache["pos"].fill_(s)
    return logits, cache
