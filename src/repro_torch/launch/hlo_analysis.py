"""Per-rank cost count of a step run on DTensors: the counterpart of the
JAX package's ``repro.launch.hlo_analysis``.

The reference parses XLA's optimized HLO, which is the per-partition
program, weighting each ``while`` body by its trip count.  The port has
no HLO: it runs the step (on real tensors, or on fake ones that allocate
nothing) under a dispatch mode that sees every op of it, a Python loop's
iterations included, and counts, **per rank**:

  * flops            -- ``torch.utils.flop_counter``'s formulas (matrix
                        products, convolutions, attention), applied to
                        the *local* ops: a DTensor op is not counted, the
                        ops that run on its local shards are, so a rank
                        reports its own share (``FlopCounterMode`` alone
                        would count the global product too); on fake
                        tensors the hand-written kernels' abstract forms
                        (``kernels.abstract``) count their products;
  * hbm_bytes        -- each input of a local op read once and each
                        output written once (views and metadata ops move
                        nothing): a proxy of the device-memory traffic of
                        an unfused eager step;
  * coll_wire_bytes  -- the functional collectives DTensor issues, by the
                        reference's ring model (``roofline.py``), with the
                        group size of each collective's process group;
  * coll_by_kind / n_collectives;
  * peak_bytes       -- the most bytes live at once: the storages of the
                        tensors held (``CostMode.hold``: parameters,
                        optimizer state, cache) plus every storage a
                        local op made, until its last tensor dies.
                        (``torch.distributed._tools.mem_tracker`` would
                        count DTensor's own shape propagation, which runs
                        on fake tensors of the *global* shapes, as live
                        memory -- 602 GiB for smollm-135m's train_4k
                        cell on 256 ranks -- so the port counts the local
                        storages itself.)

The module keeps the reference's name so that a reader finds the
counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import sys
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..kernels.abstract import KERNEL_FLOPS

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")

_aten = torch.ops.aten
# ops that move no bytes: views, metadata, and the wait of an async collective
_NO_BYTES = {
    _aten.view, _aten._unsafe_view, _aten.reshape, _aten.t, _aten.transpose, _aten.permute,
    _aten.expand, _aten.slice, _aten.select, _aten.unsqueeze, _aten.squeeze, _aten.alias,
    _aten.detach, _aten.as_strided, _aten.split, _aten.split_with_sizes, _aten.unbind,
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.lift_fresh, _aten.view_as_real,
    _aten._local_scalar_dense, _aten.sym_size, _aten.sym_stride, _aten.sym_numel,
}


@dataclass
class Costs:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_wire_bytes: float = 0.0
    coll_by_kind: dict = field(default_factory=dict)
    n_collectives: int = 0
    peak_bytes: float = 0.0

    def scale(self, mult: float) -> None:
        """Weight the counts (not the peak) by a trip count."""
        self.flops *= mult
        self.hbm_bytes *= mult
        self.coll_wire_bytes *= mult
        self.coll_by_kind = {k: v * mult for k, v in self.coll_by_kind.items()}
        self.n_collectives = int(self.n_collectives * mult)

    def add_coll(self, kind: str, b: float, mult: float = 1.0):
        self.coll_wire_bytes += b * mult
        self.coll_by_kind[kind] = self.coll_by_kind.get(kind, 0.0) + b * mult
        self.n_collectives += 1


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _group_size(name, default: int) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    try:
        return _resolve_process_group(name).size()
    except (RuntimeError, ValueError, KeyError):
        return default


def _collective(func, args, out):
    """(kind, result bytes, group size or None) of a functional collective."""
    name = func._overloadpacket.__name__
    if func.namespace != "_c10d_functional":
        return None
    if name == "all_reduce":
        return "all-reduce", _nbytes(args[0]), args[2]
    if name == "all_gather_into_tensor":
        return "all-gather", _nbytes(out), args[2]
    if name == "reduce_scatter_tensor":
        return "reduce-scatter", _nbytes(out), args[3]
    if name == "all_to_all_single":
        return "all-to-all", _nbytes(out), args[3]
    return None


_PROPAGATION = ("_sharding_prop.py", "_op_schema.py")


def _in_dtensor_propagation(depth: int = 16) -> bool:
    """Whether the op was called by DTensor's sharding propagation, which
    runs the op on (fake) tensors of the global shapes to learn its
    output's: not a rank's work."""
    f = sys._getframe(2)
    for _ in range(depth):
        if f is None:
            return False
        if f.f_code.co_filename.endswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


class CostMode(TorchDispatchMode):
    """Counts :class:`Costs` of the local ops run under it (see the module
    docstring).  ``n_devices`` is the group size of a collective whose
    process group cannot be resolved; ``fake_mode``, the ``FakeTensorMode``
    the step runs under, if it runs on fake tensors (DTensor's own shape
    propagation runs on fake tensors of another mode, and is not counted)."""

    def __init__(self, n_devices: int = 1, fake_mode=None):
        super().__init__()
        self.costs = Costs()
        self.n_devices = n_devices
        self.fake_mode = fake_mode
        self._live: dict[int, list] = {}  # storage -> [live tensors, bytes]
        self._live_bytes = 0

    def hold(self, *tensors) -> None:
        """Count the storages of ``tensors`` (a DTensor's local shard) as
        live for the whole run: the state the step starts from."""
        for t in tensors:
            if isinstance(t, DTensor):
                t = t.to_local()
            key = t.untyped_storage()._cdata
            if key not in self._live:
                self._live[key] = [1, t.untyped_storage().nbytes()]
                self._live_bytes += self._live[key][1]
        self.costs.peak_bytes = max(self.costs.peak_bytes, self._live_bytes)

    def _track(self, t: torch.Tensor) -> None:
        key = t.untyped_storage()._cdata
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [0, t.untyped_storage().nbytes()]
            self._live_bytes += entry[1]
            self.costs.peak_bytes = max(self.costs.peak_bytes, self._live_bytes)
        entry[0] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[0] -= 1
        if entry[0] == 0:
            self._live_bytes -= entry[1]
            del self._live[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor run first: its redistributions and local ops then
            # come back through this mode, on the local shards
            return NotImplemented
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        flat = tree_flatten((args, kwargs))[0]
        if _in_dtensor_propagation() or any(
                isinstance(a, torch.Tensor) and a.is_meta or
                isinstance(a, FakeTensor) and a.fake_mode is not self.fake_mode for a in flat):
            return out  # DTensor's shape propagation, on the global shapes
        c = self.costs
        coll = _collective(func, args, out)
        if coll is not None:
            kind, rb, group = coll
            g = _group_size(group, self.n_devices)
            frac = (g - 1) / g if g > 1 else 0.0
            if kind == "all-reduce":
                c.add_coll(kind, 2.0 * rb * frac)
            elif kind == "reduce-scatter":
                c.add_coll(kind, rb * (g - 1))
            else:
                c.add_coll(kind, rb * frac)
            return out
        for o in tree_flatten(out)[0]:
            if isinstance(o, torch.Tensor):
                self._track(o)
        packet = func._overloadpacket
        if packet in flop_registry:
            c.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        elif func.namespace == "repro_torch" and packet.__name__ in KERNEL_FLOPS:
            c.flops += KERNEL_FLOPS[packet.__name__](*args, **kwargs)
        if packet not in _NO_BYTES and func.namespace in ("aten", "repro_torch"):
            c.hbm_bytes += sum(_nbytes(a) for a in flat)
            c.hbm_bytes += sum(_nbytes(o) for o in tree_flatten(out)[0])
        return out


def analyze(fn, *args, n_devices: int = 1, fake_mode=None, **kwargs) -> Costs:
    """Run ``fn(*args, **kwargs)`` and return its per-rank :class:`Costs`."""
    with CostMode(n_devices, fake_mode) as mode:
        fn(*args, **kwargs)
    return mode.costs
