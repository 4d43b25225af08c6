"""Roofline terms of a step on the production mesh: the port of the JAX
package's ``repro.launch.roofline``, with the H100's figures in place of
the TPU v5e's.

Three terms per (arch x shape x mesh), in seconds, per rank (one card):

    compute    = FLOPs_per_rank      / PEAK_FLOPS  (bf16 tensor-core peak)
    memory     = bytes_per_rank      / HBM_BW      (HBM3 bandwidth)
    collective = coll_bytes_per_rank / LINK_BW     (NVLink, one direction)

The counts come from :func:`repro_torch.launch.hlo_analysis.analyze`
(per rank, from the local shards); collective wire bytes follow the
reference's ring model:

    all-reduce         2 x size x (G-1)/G
    all-gather         size x (G-1)/G      (size: the gathered result)
    reduce-scatter     size x (G-1)        (size: one rank's result)
    all-to-all         size x (G-1)/G

``model_flops`` is 6*N*D (train) or 2*N*D (inference) with N the active
parameters and D the tokens; MODEL_FLOPS / counted FLOPs exposes remat and
redundant compute.  Every figure below is arithmetic on a data sheet, not
a measurement: no term here says how fast a step runs.
"""

from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM data sheet figures (dense, no sparsity, at the 700 W limit)
PEAK_FLOPS = 989e12  # bf16 tensor-core FLOP/s per card (data sheet)
HBM_BW = 3.35e12  # HBM3 bytes/s per card (data sheet)
LINK_BW = 450e9  # NVLink 4 bytes/s per card, one direction (data sheet: 900 GB/s both ways)
HBM_BYTES = 80e9  # device memory per card (data sheet)


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_by_kind: dict
    model_flops_total: float
    memory_per_chip_bytes: float  # the peak estimate of the dry-run

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / total counted FLOPs (remat/redundancy waste)."""
        total = self.flops_per_chip * self.n_devices
        return self.model_flops_total / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Upper bound on MFU implied by the dominant roofline term."""
        t = self.t_bound
        if t == 0:
            return 0.0
        return self.model_flops_total / (self.n_devices * PEAK_FLOPS * t)

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops_total,
            "flops_per_chip": self.flops_per_chip,
            "hbm_bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "coll_by_kind": self.coll_by_kind,
            "useful_flops_fraction": self.useful_flops_fraction,
            "mfu_bound": self.mfu_bound,
            "memory_per_chip_gb": self.memory_per_chip_bytes / 2**30,
        }


def model_flops(cfg, shape) -> float:
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch  # decode: one token per sequence
