"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048
(per expert) vocab=163840, MoE 384e top-8 — trillion-parameter MoE
(paper-table config).  61 layers is prime-ish for scanning: we scan 61
periods of one layer.  Training this at single-pod scale requires
adafactor + fsdp_over_pod (see EXPERIMENTS.md §Dry-run notes).
[arXiv:2501.kimi2; unverified]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    n_experts=384,
    experts_per_token=8,
)
