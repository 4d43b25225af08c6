"""Abstract stand-ins for every (arch x shape) cell: the port of the JAX
package's ``repro.launch.specs``.

Where JAX uses ``ShapeDtypeStruct``, the port uses meta-device tensors:
shapes and dtypes, no storage.  Params, batches and caches are all
abstract; the dry-run lays them out on the production mesh as fake
tensors.
"""

from __future__ import annotations

import torch

from ..configs import applicable_shapes
from ..configs.base import ArchConfig, ShapeConfig
from ..distributed import MeshRules
from ..models import init_cache
from ..models.transformer import torch_dtype
from ..tree import tree_map


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Abstract inputs for one cell (excluding params/cache)."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    dt = torch_dtype(cfg)

    def tok(n):
        return _meta((b, n), i32)

    if shape.kind == "train":
        batch = {"tokens": tok(s), "labels": tok(s)}
        if cfg.family == "vlm":
            # image tokens replace a prefix of the sequence budget
            batch = {
                "tokens": tok(s - cfg.vision_tokens),
                "labels": tok(s - cfg.vision_tokens),
                "img_embeds": _meta((b, cfg.vision_tokens, cfg.d_model), dt),
            }
        if cfg.family == "encdec":
            batch["enc_frames"] = _meta((b, cfg.encoder_seq, cfg.d_model), dt)
        return batch

    if shape.kind == "prefill":
        batch = {"tokens": tok(s)}
        if cfg.family == "vlm":
            batch = {
                "tokens": tok(s - cfg.vision_tokens),
                "img_embeds": _meta((b, cfg.vision_tokens, cfg.d_model), dt),
            }
        if cfg.family == "encdec":
            batch["enc_frames"] = _meta((b, cfg.encoder_seq, cfg.d_model), dt)
        return batch

    # decode: one new token against a seq_len-deep cache
    return {"tokens": tok(1)}


def batch_shardings(cfg: ArchConfig, shape: ShapeConfig, rules: MeshRules) -> dict:
    """Each input's (mesh, placements): the batch dim on the batch axes."""
    specs = input_specs(cfg, shape)
    return tree_map(lambda leaf: rules.sharding(("batch",) + (None,) * (leaf.ndim - 1),
                                                leaf.shape), specs)


def abstract_cache(cfg: ArchConfig, shape: ShapeConfig):
    return init_cache(cfg, shape.global_batch, shape.seq_len, abstract=True)


def cell_names(cfg: ArchConfig) -> list[str]:
    return applicable_shapes(cfg)
