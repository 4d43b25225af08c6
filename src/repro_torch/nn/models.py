"""The paper's benchmark networks (§6.2), as quantized Sequential specs.

Datasets are not redistributable offline; training uses synthetic tasks
(examples/) — the *hardware* results (adders, LUT bits, depth, latency)
depend only on architecture + weight statistics, which is what the
benchmark harness reproduces.

  jet_tagger      §6.2.1: high-level-feature jet tagging MLP,
                  16 -> 64 -> 32 -> 16 -> 16 -> 5 dense + ReLU.
  svhn_cnn        §6.2.2: LeNet-like SVHN classifier [3, 16]:
                  conv16-pool-conv16-pool-conv24-pool-dense42-dense64-dense10.
  muon_tracker    §6.2.3: multi-stage dense network (binary inputs,
                  structured sparsity approximated by plain dense stages).
  mlp_mixer_jet   §6.2.4 [49]: 4 MLP blocks alternating feature-mix /
                  particle-mix with one skip connection, 64 particles x
                  16 features, 5-class head.
"""

from __future__ import annotations

from .layers import (
    AvgPool2D,
    Flatten,
    MaxPool2D,
    QConv2D,
    QDense,
    QDenseOnAxis,
    ReLU,
    Residual,
)
from .quant import QuantConfig


def _act(bits: int) -> QuantConfig:
    # unsigned post-ReLU activations: fixed<0, bits, bits/2>
    return QuantConfig(bits, max(bits // 2, 1), signed=False)


def _wq(bits: int) -> QuantConfig:
    # weights in [-2, 2): fixed<1, bits, 2>
    return QuantConfig(bits, 2, signed=True)


def jet_tagger(w_bits: int = 6, a_bits: int = 8):
    """16 -> 64 -> 32 -> 16 -> 16 -> 5 fully-connected tagger."""
    wq, aq = _wq(w_bits), _act(a_bits)
    model = (
        QDense(64, wq), ReLU(aq),
        QDense(32, wq), ReLU(aq),
        QDense(16, wq), ReLU(aq),
        QDense(16, wq), ReLU(aq),
        QDense(5, wq),
    )
    in_quant = QuantConfig(8, 4, signed=True)
    return model, (16,), in_quant


def svhn_cnn(w_bits: int = 6, a_bits: int = 8):
    """LeNet-like SVHN classifier (paper Fig. 8).

    VALID convolutions, so the 32x32 SVHN frame is center-cropped to
    30x30 (the standard hls4ml variant uses SAME padding; resource
    counts are equivalent — the CMVM kernels are identical)."""
    wq, aq = _wq(w_bits), _act(a_bits)
    model = (
        QConv2D(16, (3, 3), w_quant=wq), ReLU(aq), MaxPool2D((2, 2)),
        QConv2D(16, (3, 3), w_quant=wq), ReLU(aq), MaxPool2D((2, 2)),
        QConv2D(24, (3, 3), w_quant=wq), ReLU(aq), AvgPool2D((2, 2)),
        Flatten(),
        QDense(42, wq), ReLU(aq),
        QDense(64, wq), ReLU(aq),
        QDense(10, wq),
    )
    in_quant = QuantConfig(8, 1, signed=False)  # pixel intensities [0,1)
    return model, (30, 30, 3), in_quant


def muon_tracker(w_bits: int = 6, a_bits: int = 8, d_in: int = 64):
    """Multi-stage dense network; inputs are 1-bit hits (paper §6.2.3:
    the initial conv stage is left un-optimized there too)."""
    wq, aq = _wq(w_bits), _act(a_bits)
    model = (
        QDense(64, wq), ReLU(aq),
        QDense(48, wq), ReLU(aq),
        QDense(32, wq), ReLU(aq),
        QDense(16, wq), ReLU(aq),
        QDense(1, wq),
    )
    in_quant = QuantConfig(1, 1, signed=False)  # binary hits
    return model, (d_in,), in_quant


def mlp_mixer_jet(
    n_particles: int = 16,
    n_features: int = 16,
    d_ff: int = 16,
    w_bits: int = 6,
    a_bits: int = 8,
    full_size: bool = False,
):
    """MLP-Mixer jet tagger (paper Fig. 10, [49]).

    MLP1/MLP3 mix the feature axis, MLP2/MLP4 mix the particle axis; one
    skip connection spans MLP2..MLP3.  ``full_size=True`` uses the
    paper's 64-particle configuration.
    """
    if full_size:
        n_particles = 64
    wq, aq = _wq(w_bits), _act(a_bits)
    mlp1 = (QDense(d_ff, wq), ReLU(aq), QDense(n_features, wq), ReLU(aq))
    mlp2 = (
        QDenseOnAxis(n_particles, axis=0, w_quant=wq), ReLU(aq),
        QDenseOnAxis(n_particles, axis=0, w_quant=wq), ReLU(aq),
    )
    mlp3 = (QDense(d_ff, wq), ReLU(aq), QDense(n_features, wq), ReLU(aq))
    mlp4 = (
        QDenseOnAxis(n_particles, axis=0, w_quant=wq), ReLU(aq),
        QDenseOnAxis(n_particles, axis=0, w_quant=wq), ReLU(aq),
    )
    head = (Flatten(), QDense(32, wq), ReLU(aq), QDense(5, wq))
    model = mlp1 + (Residual(mlp2 + mlp3),) + (ReLU(aq),) + mlp4 + head
    in_quant = QuantConfig(8, 4, signed=True)
    return model, (n_particles, n_features), in_quant
