"""Logical-axis sharding rules on DTensor: the port of the JAX package's
``repro.distributed.sharding``.

Mesh dims: ``("data", "model")`` single-pod (16x16 = 256 ranks) or
``("pod", "data", "model")`` multi-pod (2x16x16 = 512), on a
``torch.distributed.device_mesh.DeviceMesh``.  Model code annotates
tensors with *logical* tokens; the rules resolve them to mesh dims with
the reference's divisibility fallback (a dim that does not divide its
mesh dims is left unsharded and recorded in ``fallbacks`` for the dry-run
report -- e.g. smollm's 9 query heads on a 16-way model axis).

Logical tokens:
    batch    -> ("pod", "data")            (whichever exist in the mesh)
    fsdp     -> ("data",) or ("pod","data") (param sharding / ZeRO-3)
    model    -> "model"                     (tensor parallel)
    seq      -> "model" when sequence parallelism is on, else None
    None     -> unsharded

:meth:`MeshRules.partition` gives the reference's ``PartitionSpec``
parts (one entry per tensor dim: None, a mesh dim name, or a tuple of
names); :meth:`MeshRules.spec` the DTensor placements (one per mesh dim).
A tensor dim sharded over ``("pod", "data")`` is ``Shard(d)`` on both
mesh dims: DTensor splits it over ``pod`` first and each piece over
``data``, which gives every rank the slice that JAX's
``NamedSharding(mesh, P(("pod", "data")))`` gives it.

Where JAX's ``with_sharding_constraint`` is a hint to the partitioner,
:func:`constrain` here redistributes the DTensor (eagerly, with the
collectives that takes).  Without active rules it returns its input
untouched; under active rules a plain tensor is an error, so a tensor
that missed ``distribute_tensor`` shows up instead of running
unsharded.
"""

from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass, field

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor


@dataclass
class MeshRules:
    mesh: DeviceMesh
    fsdp_over_pod: bool = False
    seq_shard: bool = False
    fsdp: bool = True  # False: replicate params over data (small-model serving)
    fallbacks: list = field(default_factory=list)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names)

    def axes_for(self, token: str | None) -> tuple[str, ...]:
        names = self.names
        if token is None:
            return ()
        if token == "batch":
            return tuple(a for a in ("pod", "data") if a in names)
        if token == "fsdp":
            if not self.fsdp:
                return ()
            if self.fsdp_over_pod and "pod" in names:
                return ("pod", "data")
            return ("data",) if "data" in names else ()
        if token == "model":
            return ("model",) if "model" in names else ()
        if token == "seq":
            return ("model",) if (self.seq_shard and "model" in names) else ()
        raise ValueError(f"unknown logical axis {token!r}")

    def _axis_size(self, axes) -> int:
        return math.prod(self.mesh.size(self.names.index(a)) for a in axes)

    def partition(self, tokens, shape=None) -> tuple:
        """The reference's ``PartitionSpec`` parts for logical ``tokens``,
        dropping non-divisible dims (trying trailing sub-tuples first)."""
        parts = []
        used: set[str] = set()
        for i, tok in enumerate(tokens):
            axes = tuple(a for a in self.axes_for(tok) if a not in used)
            if not axes:
                parts.append(None)
                continue
            if shape is not None and shape[i] % self._axis_size(axes):
                # try trailing sub-tuples (e.g. batch=("pod","data")->("data",))
                ok = ()
                for k in range(1, len(axes)):
                    sub = axes[k:]
                    if shape[i] % self._axis_size(sub) == 0:
                        ok = sub
                        break
                if not ok:
                    self.fallbacks.append((tokens, i, tok, shape[i]))
                parts.append(ok if len(ok) != 1 else ok[0])
                used.update(ok)
                continue
            used.update(axes)
            parts.append(axes if len(axes) != 1 else axes[0])
        return tuple(None if p == () else p for p in parts)

    def placements(self, parts) -> tuple:
        """DTensor placements (one per mesh dim) of ``PartitionSpec`` parts.
        A mesh dim of size 1 is ``Replicate()``: a shard over one rank is
        the whole tensor, and DTensor's view ops refuse to merge a dim
        "sharded" so (the 1x1 mesh of one card)."""
        out = [Replicate()] * len(self.names)
        for dim, part in enumerate(parts):
            axes = (part,) if isinstance(part, str) else (part or ())
            idx = [self.names.index(a) for a in axes]
            if idx != sorted(idx):
                # DTensor splits a dim over mesh dims in mesh order
                raise ValueError(f"dim {dim} sharded over {axes} out of mesh order {self.names}")
            for j in idx:
                if self.mesh.size(j) > 1:
                    out[j] = Shard(dim)
        return tuple(out)

    def spec(self, tokens, shape=None) -> tuple:
        """DTensor placements for logical tokens, non-divisible dims dropped."""
        return self.placements(self.partition(tokens, shape))

    def sharding(self, tokens, shape=None):
        """(mesh, placements): what ``distribute_tensor`` takes."""
        return self.mesh, self.spec(tokens, shape)

    def distribute(self, x: torch.Tensor, *tokens) -> DTensor:
        """A plain tensor (the same on every rank) laid out by ``tokens``:
        each rank keeps its own shard, nothing is sent."""
        return distribute_tensor(x, self.mesh, self.spec(tokens, x.shape), src_data_rank=None)

    def constrain(self, x, *tokens):
        if not isinstance(x, DTensor):
            raise TypeError(f"constrain{tokens}: a plain {tuple(x.shape)} tensor under active "
                            "sharding rules (distribute it first)")
        if len(tokens) != x.ndim:
            raise ValueError(f"constrain{tokens}: {len(tokens)} tokens for a {x.ndim}-d tensor")
        placements = self.spec(tokens, x.shape)
        if tuple(x.placements) == placements:
            return x
        return x.redistribute(self.mesh, placements)


_local = threading.local()


def current_rules() -> MeshRules | None:
    return getattr(_local, "rules", None)


@contextlib.contextmanager
def use_rules(rules: MeshRules | None):
    prev = current_rules()
    _local.rules = rules
    try:
        yield rules
    finally:
        _local.rules = prev


def constrain(x, *tokens):
    """Redistribute ``x`` to its logical layout if a mesh is active (a
    no-op without rules, on one device)."""
    rules = current_rules()
    if rules is None:
        return x
    return rules.constrain(x, *tokens)


def axis_size(token: str) -> int:
    """Mesh extent of a logical axis (1 when no mesh is active)."""
    rules = current_rules()
    if rules is None:
        return 1
    return rules._axis_size(rules.axes_for(token))


def gathered(w, *axes):
    """FSDP weight-gather: a parameter in its compute layout (fsdp dim
    unsharded) right before use, as the reference's hint does."""
    return constrain(w, *axes)


def like(t: torch.Tensor, ref):
    """``t``, computed the same on every rank (positions, masks, zeros),
    as a replicated DTensor on ``ref``'s mesh when ``ref`` is a DTensor,
    so that it can meet ``ref`` in an op; else ``t`` itself."""
    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, ref.device_mesh, [Replicate()] * ref.device_mesh.ndim,
                              run_check=False)


def run_local(fn, args, in_placements, out_placements, mesh, in_grad_placements=None):
    """``fn(*args)`` on each rank's local shards, through ``local_map``:
    every DTensor argument is first redistributed to its entry of
    ``in_placements`` (None for an argument that is not a tensor), and
    the outputs come back as DTensors placed by ``out_placements``.  This
    is how the hand-written kernels (and the few ops without a DTensor
    sharding strategy) run under the rules: a ``torch.autograd.Function``
    does not take DTensors, so each rank calls it on its own shard."""
    from torch.distributed.tensor.experimental import local_map

    moved = [a.redistribute(mesh, pl) if isinstance(a, DTensor) and tuple(a.placements) != pl
             else a for a, pl in zip(args, in_placements)]
    # local_map reads a tuple as one entry per output, a list as one output's
    if all(isinstance(p, Placement) for p in out_placements):
        out_placements = list(out_placements)
    else:
        out_placements = tuple(list(p) for p in out_placements)
    return local_map(fn, out_placements=out_placements, in_placements=tuple(in_placements),
                     in_grad_placements=in_grad_placements, device_mesh=mesh)(*moved)


def batch_local(fn, *args, n_out: int = 1):
    """``fn`` over batch groups: each DTensor argument is laid out with
    its dim 0 on the batch mesh dims (where it divides them) and
    replicated on the others, and
    ``fn`` runs on each rank's rows (an op of the group dim alone, with no
    DTensor sharding strategy); its ``n_out`` outputs come back laid out
    the same way.  Without a DTensor argument, ``fn(*args)``."""
    ref = next((a for a in args if isinstance(a, DTensor)), None)
    if ref is None:
        return fn(*args)
    rules = current_rules()
    if rules is None:
        raise RuntimeError("DTensor arguments without active sharding rules")
    pl = rules.spec(("batch",), ref.shape[:1])  # the group dim, if it divides
    mesh = rules.mesh
    ins = [pl if isinstance(a, DTensor) else None for a in args]
    return run_local(fn, args, ins, pl if n_out == 1 else (pl,) * n_out, mesh)
