"""whisper-base [audio]: 6L enc + 6L dec, d_model=512 8H d_ff=2048
vocab=51865 — enc-dec; the conv audio frontend is a STUB (input_specs
provides precomputed frame embeddings [B, 1500, 512]).
[arXiv:2212.04356; unverified]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    encoder_layers=6,
    encoder_seq=1500,
)
