"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336,
MoE 16e top-2 — Mamba+attention 1:7 interleave (one attention layer per
8), MoE every other layer.  [arXiv:2403.19887; hf]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    experts_per_token=2,
    moe_every=2,
    ssm_state=16,
    attn_every=8,
)
