"""Architecture + run configuration schema for the LM framework.

Every assigned architecture is an ``ArchConfig`` in this package
(``--arch <id>`` in the launchers).  ``layer_pattern`` describes one
period of the (mixer, ffn) stack — the transformer scan iterates over
periods with the period body unrolled, which keeps HLO size O(period)
instead of O(n_layers) while supporting heterogeneous stacks (Jamba's
1:7 attention:Mamba interleave with MoE on odd layers).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

ATTN, SSM = "attn", "ssm"
MLP, MOE = "mlp", "moe"


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e4
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1  # MoE ffn every k-th layer (1 = all layers when n_experts>0)
    capacity_factor: float = 1.25

    # --- SSM (Mamba-1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    attn_every: int = 0  # hybrid: one attention layer per `attn_every` layers

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0  # frontend-stub frames per example

    # --- VLM (frontend stub) ---
    vision_tokens: int = 0

    # --- numerics / perf knobs ---
    dtype: str = "bfloat16"
    remat: str = "full"  # full | dots | none
    scan_layers: bool = True
    # Pallas path in the JAX package.  In the port it selects nothing: a
    # CUDA tensor always takes the Hopper kernel, a CPU tensor its plain version.
    use_flash_kernel: bool = False
    ssm_chunk: int = 128
    # "seq": time-major sequential scan — HBM-optimal (the traffic pattern
    # of a fused kernel; ~20x less scan traffic than the Blelloch
    # associative scan XLA emits), serial depth S.  "assoc": chunked
    # associative scan — log-depth, memory-hungry.
    ssm_mode: str = "seq"

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab_size // 256) * 256

    @property
    def dt_rank(self) -> int:
        return max(self.d_model // 16, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def layer_pattern(self) -> tuple[list[tuple[str, str | None]], int]:
        """Returns (one period of (mixer, ffn) entries, n_periods)."""
        if self.family == "ssm":
            return [(SSM, None)], self.n_layers
        if self.family == "hybrid":
            p = self.attn_every or 8
            period = []
            for i in range(p):
                mixer = ATTN if i == p // 2 else SSM
                ffn = MOE if (self.n_experts and i % max(self.moe_every, 1) == 1) else MLP
                period.append((mixer, ffn))
            assert self.n_layers % p == 0
            return period, self.n_layers // p
        ffn = MOE if self.n_experts else MLP
        if self.n_experts and self.moe_every > 1:
            period = [
                (ATTN, MOE if i % self.moe_every == self.moe_every - 1 else MLP)
                for i in range(self.moe_every)
            ]
            assert self.n_layers % self.moe_every == 0
            return period, self.n_layers // self.moe_every
        return [(ATTN, ffn)], self.n_layers

    def param_count(self) -> int:
        """Total parameters (exact for our parameterization)."""
        d, v, hd = self.d_model, self.padded_vocab, self.hd
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d  # lm head
        total += d  # final norm
        period, n_periods = self.layer_pattern()
        for mixer, ffn in period:
            total += n_periods * d  # pre-mixer norm
            if mixer == ATTN:
                q = d * self.n_heads * hd
                kv = 2 * d * self.n_kv_heads * hd
                o = self.n_heads * hd * d
                total += n_periods * (q + kv + o)
                if self.qk_norm:
                    total += n_periods * 2 * hd
            else:
                di, st, dtr = self.d_inner, self.ssm_state, self.dt_rank
                total += n_periods * (
                    d * 2 * di  # in_proj
                    + di * self.ssm_conv  # conv
                    + di * (dtr + 2 * st)  # x_proj
                    + dtr * di + di  # dt_proj
                    + di * st + di  # A_log, D
                    + di * d  # out_proj
                )
            if ffn is not None:
                total += n_periods * d  # pre-ffn norm
                if ffn == MLP:
                    total += n_periods * 3 * d * self.d_ff
                else:
                    total += n_periods * (
                        d * self.n_experts + self.n_experts * 3 * d * self.d_ff
                    )
        if self.family == "encdec":
            # encoder layers (self-attn + mlp) and decoder cross-attn
            attn_p = 2 * d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
            if self.qk_norm:
                attn_p += 2 * hd
            enc = self.encoder_layers * (2 * d + attn_p + 3 * d * self.d_ff)
            cross = self.n_layers * (d + attn_p)
            total += enc + cross + d
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        period, n_periods = self.layer_pattern()
        n_moe = sum(1 for _, f in period if f == MOE) * n_periods
        inactive = n_moe * (self.n_experts - self.experts_per_token) * 3 * d * self.d_ff
        return self.param_count() - inactive


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (assigned per architecture)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class RunConfig:
    """Training/serving run options (optimizer, parallelism, fault tol)."""

    optimizer: str = "adamw"  # adamw | adafactor
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    master_dtype: str | None = "float32"  # None: bf16 params are master
    state_dtype: str | None = None  # 'int8' enables 8-bit Adam states
    microbatch: int = 1  # gradient-accumulation chunks
    fsdp_over_pod: bool = False  # shard params across pods too (1T-scale)
    seq_shard: bool = False  # sequence parallelism for long-context
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3


def reduced(cfg: ArchConfig, **kw) -> ArchConfig:
    """Smoke-test-sized variant of an architecture (same family/pattern)."""
    period = 1
    if cfg.family == "hybrid":
        period = cfg.attn_every or 8
    n_layers = kw.pop("n_layers", 2 * period if cfg.family == "hybrid" else 2)
    if cfg.n_experts and cfg.moe_every > 1:
        n_layers = max(n_layers, cfg.moe_every)
        n_layers -= n_layers % cfg.moe_every
    defaults = dict(
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 8),
        experts_per_token=min(cfg.experts_per_token, 2),
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq=min(cfg.encoder_seq, 16),
        vision_tokens=min(cfg.vision_tokens, 8),
        ssm_state=min(cfg.ssm_state, 8),
        dtype="float32",
        ssm_chunk=16,
        # tiny token counts make capacity drops likely at cf=1.25, which
        # breaks decode-vs-teacher-forcing equivalence checks; smoke
        # configs use a drop-free capacity
        capacity_factor=4.0,
    )
    defaults.update(kw)
    return replace(cfg, name=cfg.name + "-smoke", **defaults)
