"""Batched LM serving engine: prefill, then decode step by step, over a
static batch of requests.

The port of the JAX package's ``serve.engine``, with its semantics: the
batch is padded to ``batch_size`` with done requests (appended to the
caller's list), one token is taken after prefill, then up to
``budget - 1`` decode steps run, a request stops when the token before
was EOS or it has its ``max_new_tokens``, and the loop ends when no
request is alive.

The JAX engine jits prefill and decode.  On the card this engine
captures ``decode_step`` once, at construction, as a CUDA graph over
static state: the decode cache (K/V preallocated to ``max_seq``, or the
SSM's conv window and state), a token buffer and the cache position,
which the captured body writes back.  A decode step is then a token copy
and one replay.  Prefill runs eagerly, once per batch, into the static
cache; an encoder-decoder's prefill writes the new encoder output's
cross K/V into the static cross cache, the tensors the graph reads.  The
pick stays outside the graph: ``argmax``, or the reference's categorical
draw -- the engine holds ``key = PRNGKey(0)`` and each pick takes
``key, sub = split(key)``, then ``categorical(sub, logits / T)``, on the
card one launch of the pick kernel (``kernels/prng``), on the CPU its
plain version -- so the tokens are the JAX engine's from the same key,
which carries across ``generate`` calls.  Its ``tolist`` syncs the host
each step, as the JAX engine's ``np.asarray(tok)`` does.  On the CPU both run
eagerly and each batch gets a fresh cache.  The SSM blocks' f32 leaves
are cast once, when the parameters move to the device.  ``extra_inputs``
(``enc_frames`` of an encoder-decoder, ``img_embeds`` of a VLM: the
stub front ends' outputs) are given once per engine, moved to its device
and added to every batch, as in the JAX engine.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import resolve_device
from ..configs.base import SSM, ArchConfig
from ..kernels.graphs import CapturedGraph, capture
from ..kernels.prng.ops import gumbel_pick
from ..models.ssm import f32_leaves
from ..models.transformer import check_supported, decode_step, init_cache, prefill, tree_map
from ..random import PRNGKey, key_words, split


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
    is greedy, or categorical at ``temperature`` from ``key`` (the
    reference's ``PRNGKey(0)`` at construction, split once a pick).
    ``extra_inputs`` (tensors or numpy arrays, each with the batch
    dimension ``batch_size``) join every batch's ``tokens``.

    On the card ``decode_graph`` is the captured decode step (its
    ``launches_by_kernel()`` are the kernel launches of one replay), over
    ``static_cache``, ``static_tokens`` and the cache's ``pos``; on the
    CPU all three are None."""

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
        extra_inputs: dict | None = None,
    ):
        check_supported(cfg)
        if sample not in ("greedy", "categorical"):
            raise ValueError(f"sample must be 'greedy' or 'categorical', got {sample!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = tree_map(lambda t: t.to(self.device), params)
        for block in self.params["blocks"]:
            if SSM in block:
                block[SSM] = f32_leaves(block[SSM])
        self.batch_size = batch_size
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.sample = sample
        self.temperature = temperature
        self.key = PRNGKey(0)
        self.extra_inputs = {k: torch.as_tensor(v).to(self.device)
                             for k, v in (extra_inputs or {}).items()}
        self.decode_graph: CapturedGraph | None = None
        self.static_cache: dict | None = None
        self.static_tokens: torch.Tensor | None = None
        if self.device.type == "cuda":
            self._capture_decode()

    @torch.inference_mode()
    def _capture_decode(self) -> None:
        """Capture one decode step over the static cache, token buffer and
        position.  The warm-up and the capture leave the cache dirty;
        every prefill zeroes it first."""
        cache = init_cache(self.cfg, self.batch_size, self.max_seq, device=self.device)
        tokens = torch.zeros((self.batch_size, 1), dtype=torch.int64, device=self.device)
        self.static_cache, self.static_tokens = cache, tokens

        def step() -> torch.Tensor:
            logits, stepped = decode_step(self.cfg, self.params, tokens, cache)
            cache["pos"].copy_(stepped["pos"])  # decode_step returns pos + 1 anew
            return logits

        with torch.cuda.device(self.device):
            self.decode_graph = capture(step)

    def _pick(self, logits: torch.Tensor) -> torch.Tensor:
        if self.sample == "greedy":
            return torch.argmax(logits, dim=-1)
        self.key, sub = split(self.key)
        return gumbel_pick(logits, *key_words(sub), self.temperature)

    @torch.inference_mode()
    def generate(self, requests: list[Request]) -> list[Request]:
        """Serve a list of requests with a fixed prompt length per batch."""
        if not 0 < len(requests) <= self.batch_size:
            raise ValueError(f"{len(requests)} requests for a batch of {self.batch_size}")
        while len(requests) < self.batch_size:
            requests.append(Request(requests[0].prompt, 0, done=True))
        prompts = np.stack([np.asarray(r.prompt, np.int64) for r in requests])
        batch = {"tokens": torch.from_numpy(prompts).to(self.device), **self.extra_inputs}
        graph = self.decode_graph
        logits, cache = prefill(self.cfg, self.params, batch, self.max_seq,
                                cache=None if graph is None else self.static_cache)
        tok = self._pick(logits)
        budget = max(r.max_new_tokens for r in requests)
        for r, t in zip(requests, tok.tolist()):
            if not r.done:
                r.out_tokens.append(int(t))
        for _ in range(budget - 1):
            if graph is None:
                logits, cache = decode_step(self.cfg, self.params, tok[:, None], cache)
            else:
                self.static_tokens.copy_(tok[:, None])
                graph.replay()
                logits = graph.output
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
