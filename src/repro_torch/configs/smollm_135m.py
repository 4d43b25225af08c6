"""smollm-135m [dense]: 30L d_model=576 9H (GQA kv=3) d_ff=1536
vocab=49152 — llama-arch small.  [hf:HuggingFaceTB/SmolLM-135M; hf]

9 query heads do not divide the 16-way model axis: the sharding rules
fall back to replicated attention heads (logged by the dry-run) while
d_ff=1536 still shards 16-way.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
)
