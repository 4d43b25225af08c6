"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff=768
(per expert) vocab=151936, MoE 128e top-8, head_dim=128, qk_norm.
[hf:Qwen/Qwen3-30B-A3B; hf]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    qk_norm=True,
    n_experts=128,
    experts_per_token=8,
    rope_theta=1e6,
)
