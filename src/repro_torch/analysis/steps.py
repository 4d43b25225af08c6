"""StepSpec pipeline checker: re-derive the design's interval flow.

The compile plan phase propagates exact per-feature ``QInterval``s
through every step (dense / conv / requant / transpose / relu / pool /
residual) and bakes the results into the design: requant shift arrays,
bias pre-shifts, residual alignment shifts, and the final
``out_qints``.  This pass *replays* that propagation from the input
quantization alone — with its own transfer functions, not the
compiler's — and checks every baked value against the re-derivation.

The one piece of information the step topology does not carry is each
CMVM's weight matrix; it is recovered **exactly** from the packed DAIS
program by evaluating it on unit vectors (the program computes
``y = x @ W`` bit-exactly, so ``W = evaluate(I)``).  The affine interval
of each output column then anchors the flow, and the program's own input
rows must carry exactly the intervals the flow derives at that point
(``DA022``) — a disagreement means the program was solved for different
input ranges than the pipeline feeds it.

Exp bookkeeping relies on two step params written at compile time:
``wscale`` on dense/conv (the weight grid exponent) and ``exp`` on
requant (the target grid exponent).  Artifacts saved before those
existed degrade gracefully: interval checks stop with one ``DA029``
info note, structural checks (shapes, table refs, array arity) continue.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..core.dais import DAISProgram
from ..core.fixed_point import QInterval
from .diagnostics import DiagnosticReport

__all__ = ["check_steps"]

_PASS = "steps"
_I32 = (-(1 << 31), (1 << 31) - 1)


# ----------------------------------------------------------------------
# Independent transfer functions (deliberately not imported from
# repro_torch.nn.compiler — the whole point is a second derivation)
# ----------------------------------------------------------------------
def _union(qs: list[QInterval]) -> QInterval:
    q0 = qs[0]
    if all(q is q0 or q == q0 for q in qs):
        return q0
    for q in qs[1:]:
        q0 = q0.union(q)
    return q0


def _requant(q: QInterval, lo: int, hi: int, exp: int) -> tuple[QInterval, bool]:
    """floor+saturate onto the fixed<lo, hi, exp> grid; returns
    (result, clipped?)."""
    if q.is_zero:
        return QInterval(0, 0, exp), False
    d = q.exp - exp
    qlo = q.lo << d if d >= 0 else q.lo >> (-d)
    qhi = q.hi << d if d >= 0 else q.hi >> (-d)
    clipped = qlo < lo or qhi > hi
    return QInterval(min(max(qlo, lo), hi), min(max(qhi, lo), hi), exp), clipped


def _affine_qints(w: np.ndarray, qin: list[QInterval]) -> list[QInterval]:
    """Exact per-output interval of ``y = x @ w`` (affine form)."""
    exps = {q.exp for q in qin}
    if len(exps) == 1 and not any(q.is_zero for q in qin):
        # vectorized fast path (uniform exp, endpoints provably inside
        # int64): per-column sum of min/max of the endpoint products
        e = exps.pop()
        try:
            lo_v = np.array([q.lo for q in qin], dtype=np.int64)
            hi_v = np.array([q.hi for q in qin], dtype=np.int64)
        except OverflowError:
            lo_v = hi_v = None
    else:
        lo_v = hi_v = None
    if lo_v is not None:
        mag = np.maximum(np.abs(lo_v), np.abs(hi_v)).astype(float)
        bound = (np.abs(w).astype(float) * mag[:, None]).sum(axis=0).max(initial=0.0)
        if bound < float(1 << 52):  # exact in float, far inside int64
            a = w * lo_v[:, None]
            b = w * hi_v[:, None]
            lows = np.minimum(a, b).sum(axis=0)
            highs = np.maximum(a, b).sum(axis=0)
            live = np.any(w != 0, axis=0)
            return [
                QInterval(int(lows[j]), int(highs[j]), e) if live[j]
                else QInterval(0, 0, 0)
                for j in range(w.shape[1])
            ]
    out: list[QInterval] = []
    for j in range(w.shape[1]):
        q: QInterval | None = None
        col = w[:, j]
        for i in np.nonzero(col)[0]:
            t = qin[int(i)].scale(int(col[i]))
            q = t if q is None else q.add(t)
        out.append(QInterval(0, 0, 0) if q is None else q)
    return out


def _exps(qints: list[QInterval], fallback: int = 0) -> list[int]:
    return [fallback if q.is_zero else q.exp for q in qints]


class _Flow:
    """Mutable walk state: feature shape + per-feature intervals.

    ``exact`` drops to False once metadata needed for exact interval
    replay is missing (legacy artifact) or a structural error makes the
    downstream flow meaningless; structural checks continue either way.
    """

    def __init__(self, shape: tuple, qints: list[QInterval]) -> None:
        self.shape = shape
        self.qints = qints
        self.exact = True


def check_steps(
    design: Any,
    report: DiagnosticReport | None = None,
    *,
    programs: list | None = None,
) -> DiagnosticReport:
    rep = report if report is not None else DiagnosticReport()
    specs = getattr(design, "step_specs", None) or []
    if programs is None:
        programs = list(getattr(design, "programs", None) or [])
    in_quant = getattr(design, "in_quant", None)
    if in_quant is None:
        rep.add(
            "DA029", "design carries no input quantization; interval flow skipped",
            loc={}, passname=_PASS,
        )
        return rep

    shape = tuple(getattr(design, "in_shape", ()) or ())
    n_feat = int(np.prod(shape)) if shape else 0
    flow = _Flow(shape, [in_quant.qint] * n_feat)
    # weight matrices recovered per program index (shared CMVMs hit once)
    w_cache: dict[int, np.ndarray | None] = {}

    _walk(specs, flow, programs, w_cache, rep, path="")

    if not flow.exact:
        return rep
    out_shape = tuple(getattr(design, "out_shape", ()) or ())
    n = int(np.prod(flow.shape)) if flow.shape else 0
    # Flatten emits no StepSpec, so a trailing flatten is invisible here:
    # a 1-D out_shape of the same flat size is the same feature order.
    flat_ok = flow.shape == out_shape or (
        n == int(np.prod(out_shape)) and (out_shape == (n,) or flow.shape == (n,))
    )
    if not flat_ok:
        rep.add(
            "DA021",
            f"final flow shape {flow.shape} != design.out_shape {out_shape}",
            loc={"step": "end"}, passname=_PASS,
        )
    else:
        claimed = list(getattr(design, "out_qints", []) or [])
        if len(claimed) != len(flow.qints):
            rep.add(
                "DA026",
                f"design.out_qints has {len(claimed)} entries, flow derives "
                f"{len(flow.qints)}",
                loc={"step": "end"}, passname=_PASS,
            )
        else:
            bad = [i for i, (c, d) in enumerate(zip(claimed, flow.qints)) if c != d]
            if bad:
                i = bad[0]
                rep.add(
                    "DA026",
                    f"{len(bad)} output interval(s) differ from the re-derived "
                    f"flow (first: feature {i}: claimed {claimed[i]}, derived "
                    f"{flow.qints[i]})",
                    loc={"step": "end", "feature": i}, passname=_PASS,
                )
    return rep


# ----------------------------------------------------------------------
def _walk(
    specs: list,
    flow: _Flow,
    programs: list,
    w_cache: dict[int, np.ndarray | None],
    rep: DiagnosticReport,
    path: str,
) -> None:
    for k, s in enumerate(specs):
        if not flow.exact:
            # the first defect (or missing legacy metadata) was reported;
            # downstream state is unknowable, so stop instead of cascading
            return
        here = f"{path}{k}"
        loc = {"step": here, "kind": getattr(s, "kind", "?")}
        kind = getattr(s, "kind", None)
        if kind == "dense":
            _step_dense(s, flow, programs, w_cache, rep, loc)
        elif kind == "conv":
            _step_conv(s, flow, programs, w_cache, rep, loc)
        elif kind == "requant":
            _step_requant(s, flow, rep, loc)
        elif kind == "transpose":
            _step_transpose(s, flow, rep, loc)
        elif kind == "relu":
            if flow.exact and flow.qints and all(q.lo >= 0 for q in flow.qints):
                rep.add(
                    "DA025", "relu over a provably non-negative flow is a no-op",
                    loc=loc, passname=_PASS,
                )
            flow.qints = [
                q if q.is_zero else QInterval(max(q.lo, 0), max(q.hi, 0), q.exp)
                for q in flow.qints
            ]
        elif kind in ("maxpool", "avgpool"):
            _step_pool(s, flow, rep, loc)
        elif kind == "residual":
            _step_residual(s, flow, programs, w_cache, rep, loc)
        else:
            rep.add("DA027", f"unknown step kind {kind!r}", loc=loc, passname=_PASS)
            flow.exact = False
            return
        if flow.exact and any(
            q.lo < _I32[0] or q.hi > _I32[1] for q in flow.qints
        ):
            rep.add(
                "DA028",
                "derived interval exceeds the int32 executor range after this step",
                loc=loc, passname=_PASS,
            )


def _cmvm_core(
    s: Any,
    qin: list[QInterval],
    programs: list,
    w_cache: dict[int, np.ndarray | None],
    rep: DiagnosticReport,
    loc: dict,
) -> list[QInterval] | None:
    """Shared dense/conv core.  Returns the per-instance output qints,
    or None when the flow cannot continue exactly."""
    t = getattr(s, "table", -1)
    if not isinstance(t, int) or not 0 <= t < len(programs):
        rep.add(
            "DA020",
            f"table index {t} out of range (design has {len(programs)} programs)",
            loc=loc, passname=_PASS,
        )
        return None
    parr = programs[t]
    if parr is None:
        rep.add(
            "DA029", f"program {t} is not packed; CMVM interval check skipped",
            loc=loc, passname=_PASS,
        )
        return None
    prog = DAISProgram.from_arrays(parr) if not isinstance(parr, DAISProgram) else parr
    if prog.n_inputs != len(qin):
        rep.add(
            "DA022",
            f"flow feeds {len(qin)} features but program {t} takes "
            f"{prog.n_inputs} inputs",
            loc=loc, passname=_PASS,
        )
        return None
    bad = [
        i for i in range(prog.n_inputs) if prog.rows[i].qint != qin[i]
    ]
    if bad:
        i = bad[0]
        rep.add(
            "DA022",
            f"{len(bad)} program input interval(s) differ from the derived "
            f"flow (first: input {i}: program {prog.rows[i].qint}, flow {qin[i]})",
            loc={**loc, "input": i}, passname=_PASS,
        )
        return None

    wscale = s.params.get("wscale")
    if wscale is None:
        rep.add(
            "DA029",
            "step lacks the 'wscale' param; exact interval replay stops here",
            loc=loc, passname=_PASS,
        )
        return None

    if t not in w_cache:
        try:
            w_cache[t] = prog.evaluate(np.eye(prog.n_inputs, dtype=np.int64))
        except Exception:
            w_cache[t] = None
    w = w_cache[t]
    if w is None:
        rep.add(
            "DA029", f"program {t} could not be evaluated for matrix recovery",
            loc=loc, passname=_PASS,
        )
        return None

    out_q = [q.shift(int(wscale)) for q in _affine_qints(w, qin)]

    bias = s.arrays.get("bias")
    shift = s.arrays.get("shift")
    if bias is None:
        if shift is not None:
            rep.add(
                "DA023", "step has a pre-shift array but no bias",
                loc=loc, passname=_PASS,
            )
        return out_q

    bias = np.asarray(bias, np.int64)
    if bias.shape != (len(out_q),):
        rep.add(
            "DA023",
            f"bias array has shape {bias.shape}, step has {len(out_q)} outputs",
            loc=loc, passname=_PASS,
        )
        return None
    e_b = int(wscale) + min(q.exp for q in qin)
    exps = _exps(out_q, fallback=e_b)
    tgt = [min(e, e_b) for e in exps]
    pre = [e - g for e, g in zip(exps, tgt)]
    want_shift = np.asarray(pre, np.int64)
    if shift is None:
        if want_shift.any():
            rep.add(
                "DA023",
                "bias pre-shift array missing but the derived flow needs "
                f"nonzero pre-shifts (first at output {int(np.nonzero(want_shift)[0][0])})",
                loc=loc, passname=_PASS,
            )
            return None
    else:
        shift = np.asarray(shift, np.int64)
        if shift.shape != want_shift.shape or (shift != want_shift).any():
            rep.add(
                "DA023",
                "bias pre-shift array differs from the derived exp alignment",
                loc=loc, passname=_PASS,
            )
            return None
    return [
        QInterval((q.lo << p) + int(b), (q.hi << p) + int(b), g)
        if not q.is_zero
        else QInterval(min(int(b), 0), max(int(b), 0), g)
        for q, b, p, g in zip(out_q, bias.tolist(), pre, tgt)
    ]


def _step_dense(
    s: Any,
    flow: _Flow,
    programs: list,
    w_cache: dict[int, np.ndarray | None],
    rep: DiagnosticReport,
    loc: dict,
) -> None:
    d_in = s.params.get("d_in")
    if flow.shape and flow.shape[-1] != d_in and int(np.prod(flow.shape)) == d_in:
        # Flatten compiles to a shape change only (no StepSpec, flat
        # feature order is preserved), so a dense over the whole flat
        # vector implies an elided flatten — replay it here.
        flow.shape = (d_in,)
    if not flow.shape or flow.shape[-1] != d_in:
        rep.add(
            "DA021",
            f"dense expects trailing dim {d_in}, flow shape is {flow.shape}",
            loc=loc, passname=_PASS,
        )
        flow.exact = False
        return
    lead = int(np.prod(flow.shape[:-1]))
    if not flow.exact:
        return
    qarr = np.array(flow.qints, dtype=object).reshape(lead, d_in)
    qin = [_union(list(qarr[:, i])) for i in range(d_in)]
    out_q = _cmvm_core(s, qin, programs, w_cache, rep, loc)
    if out_q is None:
        flow.exact = False
        return
    flow.shape = flow.shape[:-1] + (len(out_q),)
    flow.qints = list(out_q) * lead


def _step_conv(
    s: Any,
    flow: _Flow,
    programs: list,
    w_cache: dict[int, np.ndarray | None],
    rep: DiagnosticReport,
    loc: dict,
) -> None:
    p = s.params
    need = ("h", "w", "cin", "kh", "kw", "sh", "sw", "oh", "ow")
    if any(p.get(k) is None for k in need):
        rep.add("DA023", "conv step params incomplete", loc=loc, passname=_PASS)
        flow.exact = False
        return
    h, w, cin = p["h"], p["w"], p["cin"]
    kh, kw, sh, sw, oh, ow = p["kh"], p["kw"], p["sh"], p["sw"], p["oh"], p["ow"]
    if flow.shape != (h, w, cin):
        rep.add(
            "DA021",
            f"conv expects input shape {(h, w, cin)}, flow shape is {flow.shape}",
            loc=loc, passname=_PASS,
        )
        flow.exact = False
        return
    if oh != (h - kh) // sh + 1 or ow != (w - kw) // sw + 1:
        rep.add(
            "DA021",
            f"conv output grid ({oh},{ow}) inconsistent with "
            f"shape/kernel/stride ({h},{w})/({kh},{kw})/({sh},{sw})",
            loc=loc, passname=_PASS,
        )
        flow.exact = False
        return
    if not flow.exact:
        return
    qarr = np.array(flow.qints, dtype=object).reshape(h, w, cin)
    qin = []
    for dy in range(kh):
        for dx in range(kw):
            for c in range(cin):
                qin.append(
                    _union(
                        [
                            qarr[i * sh + dy, j * sw + dx, c]
                            for i in range(oh)
                            for j in range(ow)
                        ]
                    )
                )
    out_q = _cmvm_core(s, qin, programs, w_cache, rep, loc)
    if out_q is None:
        flow.exact = False
        return
    flow.shape = (oh, ow, len(out_q))
    flow.qints = list(out_q) * (oh * ow)


def _step_requant(s: Any, flow: _Flow, rep: DiagnosticReport, loc: dict) -> None:
    d = s.arrays.get("d")
    if d is None or np.asarray(d).shape != (len(flow.qints),):
        rep.add(
            "DA023",
            f"requant shift array missing or wrong length "
            f"(flow has {len(flow.qints)} features)",
            loc=loc, passname=_PASS,
        )
        flow.exact = False
        return
    lo, hi = s.params.get("lo"), s.params.get("hi")
    if lo is None or hi is None or lo > hi:
        rep.add(
            "DA023", f"requant clip range ({lo}, {hi}) malformed",
            loc=loc, passname=_PASS,
        )
        flow.exact = False
        return
    if not flow.exact:
        return
    exp = s.params.get("exp")
    if exp is None:
        rep.add(
            "DA029",
            "requant step lacks the 'exp' param; exact interval replay stops here",
            loc=loc, passname=_PASS,
        )
        flow.exact = False
        return
    exp = int(exp)
    d = np.asarray(d, np.int64)
    want_d = np.asarray(
        [e - exp for e in _exps(flow.qints, fallback=exp)], np.int64
    )
    if (d != want_d).any():
        i = int(np.nonzero(d != want_d)[0][0])
        rep.add(
            "DA023",
            f"requant shift array differs from the derived exp delta "
            f"(first at feature {i}: stored {int(d[i])}, derived {int(want_d[i])})",
            loc={**loc, "feature": i}, passname=_PASS,
        )
        flow.exact = False
        return
    new_q, any_clip, any_change = [], False, False
    for q in flow.qints:
        nq, clipped = _requant(q, int(lo), int(hi), exp)
        any_clip = any_clip or clipped
        any_change = any_change or nq != q
        new_q.append(nq)
    if any_clip:
        rep.add(
            "DA024",
            "derived interval exceeds the requant clip range; values will saturate",
            loc=loc, passname=_PASS,
        )
    if not any_change and not d.any() and flow.qints:
        rep.add(
            "DA025", "requant is a provable no-op on the derived flow",
            loc=loc, passname=_PASS,
        )
    flow.qints = new_q


def _step_transpose(s: Any, flow: _Flow, rep: DiagnosticReport, loc: dict) -> None:
    shape = tuple(s.params.get("shape") or ())
    perm = tuple(s.params.get("perm") or ())
    if shape != flow.shape:
        rep.add(
            "DA021",
            f"transpose declares shape {shape}, flow shape is {flow.shape}",
            loc=loc, passname=_PASS,
        )
        flow.exact = False
        return
    if sorted(perm) != list(range(len(shape))):
        rep.add(
            "DA023", f"transpose perm {perm} is not a permutation",
            loc=loc, passname=_PASS,
        )
        flow.exact = False
        return
    flow.shape = tuple(shape[i] for i in perm)
    if flow.exact:
        arr = np.array(flow.qints, dtype=object).reshape(shape)
        flow.qints = list(arr.transpose(perm).reshape(-1))


def _step_pool(s: Any, flow: _Flow, rep: DiagnosticReport, loc: dict) -> None:
    p = s.params
    h, w, c, ph, pw = (p.get(k) for k in ("h", "w", "c", "ph", "pw"))
    if None in (h, w, c, ph, pw):
        rep.add("DA023", "pool step params incomplete", loc=loc, passname=_PASS)
        flow.exact = False
        return
    if flow.shape != (h, w, c) or h % ph or w % pw:
        rep.add(
            "DA021",
            f"pool window ({ph},{pw}) does not tile flow shape {flow.shape} "
            f"(declared {(h, w, c)})",
            loc=loc, passname=_PASS,
        )
        flow.exact = False
        return
    is_avg = s.kind == "avgpool"
    k = ph * pw
    if is_avg and k & (k - 1):
        rep.add(
            "DA023", f"avgpool window {ph}x{pw} is not a power of two",
            loc=loc, passname=_PASS,
        )
        flow.exact = False
        return
    flow.shape = (h // ph, w // pw, c)
    if not flow.exact:
        return
    qarr = np.array(flow.qints, dtype=object).reshape(h, w, c)
    new = []
    for i in range(h // ph):
        for j in range(w // pw):
            for ch in range(c):
                block = [
                    qarr[i * ph + a, j * pw + b, ch]
                    for a in range(ph)
                    for b in range(pw)
                ]
                if is_avg:
                    q = block[0]
                    for qq in block[1:]:
                        q = q.add(qq)
                    new.append(q.shift(-int(k).bit_length() + 1))
                else:
                    new.append(_union(block))
    flow.qints = new


def _step_residual(
    s: Any,
    flow: _Flow,
    programs: list,
    w_cache: dict[int, np.ndarray | None],
    rep: DiagnosticReport,
    loc: dict,
) -> None:
    body = getattr(s, "body", None) or []
    inner = _Flow(flow.shape, list(flow.qints))
    inner.exact = flow.exact
    _walk(body, inner, programs, w_cache, rep, path=f"{loc['step']}/body/")
    if inner.shape != flow.shape:
        rep.add(
            "DA021",
            f"residual body changes shape {flow.shape} -> {inner.shape}",
            loc=loc, passname=_PASS,
        )
        flow.exact = False
        return
    sa = s.arrays.get("sa")
    sb = s.arrays.get("sb")
    n = len(flow.qints)
    if sa is None or sb is None or np.asarray(sa).shape != (n,) or np.asarray(sb).shape != (n,):
        rep.add(
            "DA023", "residual alignment arrays missing or wrong length",
            loc=loc, passname=_PASS,
        )
        flow.exact = False
        return
    if not (flow.exact and inner.exact):
        flow.exact = False
        return
    ea = _exps(flow.qints)
    eb = _exps(inner.qints)
    e = [min(a, b) for a, b in zip(ea, eb)]
    want_sa = np.asarray([a - x for a, x in zip(ea, e)], np.int64)
    want_sb = np.asarray([b - x for b, x in zip(eb, e)], np.int64)
    if (np.asarray(sa, np.int64) != want_sa).any() or (
        np.asarray(sb, np.int64) != want_sb
    ).any():
        rep.add(
            "DA023",
            "residual alignment shifts differ from the derived exp alignment",
            loc=loc, passname=_PASS,
        )
        flow.exact = False
        return
    new = []
    for qa, qb, ee in zip(flow.qints, inner.qints, e):
        qa2 = qa if not qa.is_zero else QInterval(0, 0, int(ee))
        qb2 = qb if not qb.is_zero else QInterval(0, 0, int(ee))
        new.append(qa2.add(qb2))
    flow.qints = new
