"""Batched LM serving engine: prefill, then decode step by step, over a
static batch of requests.

The port of the JAX package's ``serve.engine``, with its semantics: the
batch is padded to ``batch_size`` with done requests (appended to the
caller's list), one token is taken after prefill, then up to
``budget - 1`` decode steps run, a request stops when the token before
was EOS or it has its ``max_new_tokens``, and the loop ends when no
request is alive.  The model runs eagerly (the JAX engine jits prefill
and decode); the decode cache (K/V preallocated to ``max_seq``, or the
SSM's conv window and state) lives on the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import resolve_device
from ..configs.base import ArchConfig
from ..models.transformer import check_supported, decode_step, prefill, tree_map


@dataclass
class Request:
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int = 32
    out_tokens: list = field(default_factory=list)
    done: bool = False


class Engine:
    """``Engine(cfg, params, batch_size, max_seq)`` serves on the CUDA
    card by default (``device=None``; raises without one) and on the CPU
    with ``device="cpu"``.  ``params`` are moved to the device.  Sampling
    is greedy, or categorical at ``temperature`` from ``generator`` (a
    ``torch.Generator`` on the device; by default one seeded with 0)."""

    def __init__(
        self,
        cfg: ArchConfig,
        params,
        batch_size: int,
        max_seq: int,
        eos_id: int = 1,
        sample: str = "greedy",
        temperature: float = 1.0,
        device=None,
        generator: torch.Generator | None = None,
    ):
        check_supported(cfg)
        if sample not in ("greedy", "categorical"):
            raise ValueError(f"sample must be 'greedy' or 'categorical', got {sample!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.batch_size = batch_size
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.sample = sample
        self.temperature = temperature
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        self.generator = generator

    def _pick(self, logits: torch.Tensor) -> torch.Tensor:
        if self.sample == "greedy":
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0]

    @torch.inference_mode()
    def generate(self, requests: list[Request]) -> list[Request]:
        """Serve a list of requests with a fixed prompt length per batch."""
        if not 0 < len(requests) <= self.batch_size:
            raise ValueError(f"{len(requests)} requests for a batch of {self.batch_size}")
        while len(requests) < self.batch_size:
            requests.append(Request(requests[0].prompt, 0, done=True))
        prompts = np.stack([np.asarray(r.prompt, np.int64) for r in requests])
        tokens = torch.from_numpy(prompts).to(self.device)
        logits, cache = prefill(self.cfg, self.params, {"tokens": tokens}, self.max_seq)
        tok = self._pick(logits)
        budget = max(r.max_new_tokens for r in requests)
        for r, t in zip(requests, tok.tolist()):
            if not r.done:
                r.out_tokens.append(int(t))
        for _ in range(budget - 1):
            logits, cache = decode_step(self.cfg, self.params, tok[:, None], cache)
            tok = self._pick(logits)
            alive = False
            for r, t in zip(requests, tok.tolist()):
                if r.done or len(r.out_tokens) >= r.max_new_tokens:
                    r.done = True
                    continue
                if r.out_tokens and r.out_tokens[-1] == self.eos_id:
                    r.done = True
                    continue
                r.out_tokens.append(int(t))
                alive = True
            if not alive:
                break
        return requests
