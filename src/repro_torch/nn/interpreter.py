"""Pure-numpy StepSpec interpreter: the serve path's degraded mode.

A copy of the JAX package's ``nn.interpreter`` (numpy only): a bit-exact
mirror of the integer executor built by
:func:`repro_torch.nn.compiler.build_steps` -- same step kinds, same
int32 arithmetic, same shift/clip/sum semantics -- expressed entirely in
numpy.  The serve engine routes batches here when
``ServeConfig.fallback="interpreter"`` and the device path is tripped or
raises: correctness survives a failing kernel or card at reduced
throughput, and the fallback shares no torch or CUDA machinery with the
failing path.

Bit-exactness notes (each is load-bearing and covered by
``tests/test_torch_interpreter.py``):

* everything runs in int32 with C wrap semantics, matching the device
  executor; reductions pass ``dtype=np.int32`` explicitly because numpy
  would otherwise widen int32 sums to the platform int,
* right shifts are arithmetic on negatives in numpy, torch and jax,
* ``np.clip`` results are cast back to int32 (value-based promotion
  against Python int bounds must not leak a wider dtype).
"""

from __future__ import annotations

from collections.abc import Callable

import numpy as np

__all__ = ["adder_graph_numpy", "build_numpy_steps", "numpy_forward_fn"]


def adder_graph_numpy(tables, x: np.ndarray) -> np.ndarray:
    """Evaluate the levelized adder graph on ``x`` [batch, n_inputs].

    numpy twin of :func:`repro_torch.kernels.adder_graph.ref.adder_graph_ref`,
    with one mechanical change: the row buffer is preallocated instead
    of grown by concatenation (same values, fewer copies).
    Returns int32 [batch, n_outputs].
    """
    x2 = np.ascontiguousarray(x).reshape(-1, x.shape[-1])
    batch = x2.shape[0]
    n_in = int(tables.n_inputs)
    instr = np.asarray(tables.instr)
    buf = np.empty((n_in + instr.shape[0], batch), dtype=np.int32)
    buf[:n_in] = x2.T.astype(np.int32)
    row = n_in
    for lo, hi in tables.level_bounds:
        ops = instr[lo:hi]
        a = buf[ops[:, 0]] << ops[:, 2][:, None]
        b = buf[ops[:, 1]] << ops[:, 3][:, None]
        buf[row : row + (hi - lo)] = a + ops[:, 4][:, None] * b
        row += hi - lo
    outs = np.asarray(tables.outs)
    y = buf[outs[:, 0]]
    shift = outs[:, 1][:, None]
    y = np.where(shift >= 0, y << np.maximum(shift, 0), y >> np.maximum(-shift, 0))
    y = y * outs[:, 2][:, None] * outs[:, 3][:, None]
    return np.ascontiguousarray(y.T.astype(np.int32))


def _build_numpy_cmvm(spec, tables):
    tab = tables[spec.table]
    bias = (
        np.asarray(spec.arrays["bias"], np.int32) if "bias" in spec.arrays else None
    )
    shift = (
        np.asarray(np.asarray(spec.arrays["shift"])[None, :], np.int32)
        if "shift" in spec.arrays
        else None
    )

    def cmvm(v, tab=tab, bias=bias, shift=shift):
        y = adder_graph_numpy(tab, v)
        if shift is not None:
            y = y << shift
        return y + bias if bias is not None else y

    return cmvm


def _build_numpy_step(spec, tables) -> Callable[[np.ndarray], np.ndarray]:
    kind, p = spec.kind, spec.params
    if kind == "dense":
        f = _build_numpy_cmvm(spec, tables)

        def step(v, d_in=p["d_in"], f=f):
            n = v.shape[0]
            return f(v.reshape(-1, d_in)).reshape(n, -1)

        return step
    if kind == "conv":
        f = _build_numpy_cmvm(spec, tables)
        h, w, cin = p["h"], p["w"], p["cin"]
        kh, kw, sh, sw = p["kh"], p["kw"], p["sh"], p["sw"]
        oh, ow = p["oh"], p["ow"]
        top, bottom, left, right = p.get("pads", (0, 0, 0, 0))
        pads = ((0, 0), (top, bottom), (left, right), (0, 0))

        def step(v, h=h, w=w, cin=cin, kh=kh, kw=kw, sh=sh, sw=sw, oh=oh, ow=ow, f=f, pads=pads):
            x = np.pad(v.reshape(-1, h, w, cin), pads)
            patches = [
                x[:, dy : dy + sh * (oh - 1) + 1 : sh, dx : dx + sw * (ow - 1) + 1 : sw, :]
                for dy in range(kh)
                for dx in range(kw)
            ]
            cols = np.concatenate(patches, axis=-1)
            y = f(cols.reshape(-1, kh * kw * cin))
            return y.reshape(-1, oh * ow * y.shape[-1])

        return step
    if kind == "requant":
        d = np.asarray(spec.arrays["d"], np.int64)
        dpos = np.asarray(np.maximum(d, 0)[None, :], np.int32)
        dneg = np.asarray(np.maximum(-d, 0)[None, :], np.int32)

        def step(v, dpos=dpos, dneg=dneg, lo=p["lo"], hi=p["hi"]):
            v = np.where(dpos > 0, v << dpos, v >> dneg)
            return np.clip(v, lo, hi).astype(np.int32)

        return step
    if kind == "transpose":
        _shape, _perm = tuple(p["shape"]), tuple(p["perm"])

        def step(v, shape=_shape, perm=_perm):
            n = v.shape[0]
            return v.reshape(n, *shape).transpose(0, *[q + 1 for q in perm]).reshape(n, -1)

        return step
    if kind == "relu":
        return lambda v: np.maximum(v, 0)
    if kind in ("maxpool", "avgpool"):
        h, w, c, ph, pw = p["h"], p["w"], p["c"], p["ph"], p["pw"]

        def step(v, h=h, w=w, c=c, ph=ph, pw=pw, is_max=(kind == "maxpool")):
            x = v.reshape(-1, h // ph, ph, w // pw, pw, c)
            if is_max:
                r = x.max(axis=(2, 4))
            else:
                # numpy widens int32 sums to the platform int by default;
                # pin int32 so wrap semantics match the jitted path
                r = x.sum(axis=(2, 4), dtype=np.int32)
            return r.reshape(v.shape[0], -1)

        return step
    if kind == "residual":
        body = tuple(_build_numpy_step(s, tables) for s in spec.body or [])
        sa = np.asarray(np.asarray(spec.arrays["sa"])[None, :], np.int32)
        sb = np.asarray(np.asarray(spec.arrays["sb"])[None, :], np.int32)

        def step(v, body=body, sa=sa, sb=sb):
            u = v
            for s in body:
                u = s(u)
            return (v << sa) + (u << sb)

        return step
    raise ValueError(f"unknown step kind {kind!r}")


def build_numpy_steps(specs, tables) -> list[Callable[[np.ndarray], np.ndarray]]:
    """numpy twin of :func:`repro_torch.nn.compiler.build_steps`."""
    return [_build_numpy_step(s, tables) for s in specs]


def numpy_forward_fn(design) -> Callable[[np.ndarray], np.ndarray]:
    """Build a numpy-only ``forward_int`` for a compiled design.

    Semantically identical to ``design.forward_int`` (same StepSpecs,
    same tables) but touching no torch code, so it keeps serving bit-exact
    answers while the device path is broken.  Raises ``ValueError`` for
    designs without step specs (hand-built designs predating the
    declarative pipeline cannot be interpreted).
    """
    if not design.step_specs:
        raise ValueError("design has no step_specs; interpreter fallback unavailable")
    steps = build_numpy_steps(design.step_specs, design.tables)
    out_shape = tuple(design.out_shape)

    def forward_int(x_int: np.ndarray) -> np.ndarray:
        v = np.asarray(x_int).reshape(x_int.shape[0], -1).astype(np.int32)
        for step in steps:
            v = step(v)
        return v.reshape(x_int.shape[0], *out_shape)

    return forward_int
