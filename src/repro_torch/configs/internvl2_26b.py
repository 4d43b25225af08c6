"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT frontend is a STUB (input_specs provides 256
patch embeddings per image); backbone is the InternLM2-20B decoder.
[arXiv:2404.16821; hf]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    vision_tokens=256,
)
