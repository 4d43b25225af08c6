"""Train-step factory (mixed precision, gradient clipping, microbatch
accumulation) and the fault-tolerant ``Trainer``: the port of the JAX
package's ``repro.train.train_lib``.

``make_train_step(cfg, run_cfg, device=...)`` returns
    train_step(params, opt_state, batch, step) -> (params, opt_state, metrics)
and ``opt_init``.  Gradients come from autograd through ``loss_fn``: on
the card every attention and Mamba layer runs the hand-written forward
kernels and, in the backward, their hand-written backward kernels.  The
step updates the parameters and the optimizer state in place (the JAX
step donates them); the microbatches accumulate into f32 buffers,
divided by ``microbatch`` as the reference divides them.

Under active sharding rules (``repro_torch.distributed.use_rules``) the
parameters, optimizer state and batch are DTensors (``models.shard_params``,
batches by ``MeshRules.distribute(x, "batch", ...)``): the same step
runs sharded, the f32 gradient accumulator pinned to the parameters'
layout (``constrain_like_params``), and each microbatch cut from the
batch gathered along its rows, then laid out on the batch dims again.

The ``Trainer`` adds checkpoint/restart (async, atomic), deterministic
data resume (the step counter is the data cursor), crash recovery with
bounded retries, and a straggler watchdog.  With ``rules`` it lays every
batch out on the mesh; checkpoints are written whole by rank 0.
"""

from __future__ import annotations

import logging
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from .._device import resolve_device
from ..configs.base import ArchConfig, RunConfig
from ..distributed import constrain, current_rules
from ..distributed.sharding import like
from ..models import loss_fn, param_specs
from ..optim import lr_schedule, make_optimizer
from ..tree import tree_leaves, tree_unflatten
from . import checkpoint

log = logging.getLogger("repro_torch.train")


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in JAX's order) of sum(x**2), in f32."""
    return torch.sqrt(sum(torch.sum(x.to(torch.float32) ** 2) for x in tree_leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float):
    """Scale every leaf by min(1, max_norm / norm) in f32, back in its own
    dtype; in place.  Returns (tree, norm)."""
    norm = global_norm(tree)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    for x in tree_leaves(tree):
        x.copy_(x.to(torch.float32) * scale)
    return tree, norm


def make_train_step(cfg: ArchConfig, run_cfg: RunConfig, device=None):
    """(train_step, opt_init) for ``cfg`` on ``device`` (default: the CUDA
    card; raises without one unless ``device="cpu"``).  ``train_step``
    takes parameters and a batch of tensors on that device."""
    dev = resolve_device(device)
    opt_init, opt_update = make_optimizer(run_cfg)
    spec_leaves = tree_leaves(param_specs(cfg))

    def constrain_like_params(leaves):
        """Pin param-shaped leaves (the f32 gradient accumulator) to the
        parameters' layout; a no-op without rules."""
        if current_rules() is None:
            return leaves
        return [constrain(x, *s.axes) for x, s in zip(leaves, spec_leaves)]

    def micro_of(v, mb, i):
        """Microbatch ``i`` of ``mb``: rows [i*B/mb, (i+1)*B/mb) of ``v``.
        A DTensor batch is gathered along its rows first and the slice laid
        out on the batch dims again (the tokens are small)."""
        if isinstance(v, DTensor):
            whole = v.redistribute(v.device_mesh, [Replicate()] * v.device_mesh.ndim)
            part = whole.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
            return constrain(part, "batch", *([None] * (v.ndim - 1)))
        return v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, parts = loss_fn(cfg, params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
        return loss.detach(), parts, grads

    def train_step(params, opt_state, batch, step):
        for k, v in batch.items():
            if v.device != dev:
                raise ValueError(f"batch[{k!r}] is on {v.device}, the step runs on {dev}")
        mb = run_cfg.microbatch
        if mb > 1:
            acc = constrain_like_params([torch.zeros_like(p, dtype=torch.float32)
                                         for p in tree_leaves(params)])
            loss = None
            for i in range(mb):
                micro = {k: micro_of(v, mb, i) for k, v in batch.items()}
                l_i, _, g_i = grads_of(params, micro)
                for a, g in zip(acc, g_i):
                    a.add_(g.to(torch.float32) / mb)
                if loss is None:
                    loss = like(torch.zeros((), dtype=torch.float32, device=dev), l_i)
                loss = loss + l_i / mb
            grads = acc
        else:
            loss, _, grads = grads_of(params, batch)
        grads, gnorm = clip_by_global_norm(grads, run_cfg.grad_clip)
        lr = lr_schedule(run_cfg, step)
        grads = tree_unflatten(params, grads)
        new_params, new_opt = opt_update(grads, opt_state, params, lr)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return new_params, new_opt, metrics

    return train_step, opt_init


class Trainer:
    """Fault-tolerant training driver (checkpoint/restart)."""

    def __init__(
        self,
        cfg: ArchConfig,
        run_cfg: RunConfig,
        pipeline,
        params,
        train_step,
        opt_state,
        step: int = 0,
        straggler_warn_s: float | None = None,
        device=None,
    ):
        self.cfg = cfg
        self.run_cfg = run_cfg
        self.pipeline = pipeline
        self.params = params
        self.opt_state = opt_state
        self.step = step
        self.train_step = train_step
        self.straggler_warn_s = straggler_warn_s
        self.device = resolve_device(device)
        self._save_thread = None
        self._step_times: list[float] = []

    # ------------------------------------------------------------------
    @classmethod
    def resume_or_init(cls, cfg, run_cfg, pipeline, init_params_fn, train_step, opt_init,
                       device=None):
        dev = resolve_device(device)
        params = init_params_fn()
        opt_state = opt_init(params)
        step = 0
        last = checkpoint.latest_step(run_cfg.checkpoint_dir)
        if last is not None:
            log.info("restoring checkpoint step %d", last)
            like_tree = {"p": params, "o": opt_state}
            state = checkpoint.restore(run_cfg.checkpoint_dir, last, like_tree,
                                       shardings=checkpoint.shardings_of(like_tree))
            params, opt_state, step = state["p"], state["o"], last
        return cls(cfg, run_cfg, pipeline, params, train_step, opt_state, step, device=dev)

    # ------------------------------------------------------------------
    def run(self, n_steps: int, max_restarts: int = 3, fail_hook=None) -> dict:
        """Run n_steps with crash recovery. ``fail_hook(step)`` may raise
        to simulate node failure (tests use this)."""
        target = self.step + n_steps
        restarts = 0
        metrics = {}
        while self.step < target:
            try:
                if fail_hook is not None:
                    fail_hook(self.step)
                metrics = self._one_step()
            except (RuntimeError, OSError) as e:  # node failure / preemption
                restarts += 1
                if restarts > max_restarts:
                    raise
                log.warning("step %d failed (%s); restoring last checkpoint", self.step, e)
                self._restore_latest()
        self._checkpoint(force=True)
        if self._save_thread is not None:
            self._save_thread.join()
        return metrics

    def _one_step(self) -> dict:
        t0 = time.perf_counter()
        batch = self.pipeline.batch_at(self.step)
        batch = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
        rules = current_rules()
        if rules is not None:  # every rank made the same batch: lay it out
            batch = {k: rules.distribute(v, "batch", *([None] * (v.ndim - 1)))
                     for k, v in batch.items()}
        self.params, self.opt_state, metrics = self.train_step(
            self.params, self.opt_state, batch, self.step
        )
        metrics = {k: float(v) for k, v in metrics.items()}  # waits for the step
        dt = time.perf_counter() - t0
        self._step_times.append(dt)
        if len(self._step_times) >= 8:
            recent = self._step_times[-16:]
            med = sorted(recent)[len(recent) // 2]
            thresh = self.straggler_warn_s if self.straggler_warn_s else 3 * med
            if dt > thresh:
                log.warning(
                    "straggler: step %d took %.2fs (median %.2fs) — on a real "
                    "fleet this triggers hot-spare promotion", self.step, dt, med,
                )
        self.step += 1
        if self.step % self.run_cfg.checkpoint_every == 0:
            self._checkpoint()
        return metrics

    def _checkpoint(self, force: bool = False):
        if self._save_thread is not None:
            self._save_thread.join()
        self._save_thread = checkpoint.save(
            self.run_cfg.checkpoint_dir,
            self.step,
            {"p": self.params, "o": self.opt_state},
            keep=self.run_cfg.keep_checkpoints,
            async_=not force,
        )

    def _restore_latest(self):
        # an async save still being written is the latest checkpoint: wait
        # for it (the JAX Trainer does not, and can find none yet)
        if self._save_thread is not None:
            self._save_thread.join()
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()  # rank 0 writes the files: wait for them on every rank
        last = checkpoint.latest_step(self.run_cfg.checkpoint_dir)
        if last is None:
            raise RuntimeError("no checkpoint to restore from")
        like_tree = {"p": self.params, "o": self.opt_state}
        state = checkpoint.restore(self.run_cfg.checkpoint_dir, last, like_tree,
                                   shardings=checkpoint.shardings_of(like_tree))
        self.params, self.opt_state, self.step = state["p"], state["o"], last
