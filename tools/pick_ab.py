"""Time an earlier tree's categorical pick kernel against this tree's on one
card, in turns (earlier, this, this, earlier), and count the instructions
of each build's inner loops.

    python tools/pick_ab.py --old DIR [--json OUT] [--sass DIR] [--splits 8,33,...] [--floor]

DIR holds the earlier tree's ``gumbel_pick.cu`` and ``threefry.cuh``
(``git show REV:src/repro_torch/kernels/prng/csrc/gumbel_pick.cu >
DIR/gumbel_pick.cu``, the same for the header).  It is built with the
port's nvcc flags into DIR/build and called through its C entry point as
that tree's wrapper called it (logits, B, V, row stride, key, T, out:
one launch, no table and no scratch).  This tree's kernel is called
through the port's wrapper, as the main path calls it.  Each time is
device ms per call by CUDA-graph replay (CUDA events around the
replays, ``chip_smoke.graph_ms``) at the shapes phase 30 of
``chip_smoke.py`` times (``chip_smoke.pick_shapes``), on its logits.
Beside each time: whether the two trees' picks are the same.

``--splits`` times this tree's kernel at [8, 49152] bf16 on each given
number of blocks a row, through the C entry point with a scratch of its
own: the kernel without the wrapper's graph buffers (33 is the plan's
count, so beside the wrapper's time it shows what those cost a call in
a 20-call graph); ``--floor`` times a
one-element ``add_`` the same way, the card's time for a kernel that
does nothing.

The instruction counts come from ``cuobjdump -sass`` of both builds:
every loop (a backward branch) of each kernel, its instructions by
opcode, and per logit (this tree's loops take ``PICK_GROUP`` logits a
pass, the earlier tree's one); with ``--sass DIR`` the SASS is written there too.
Prints, and writes to OUT, one JSON object; ptxas's ``-v`` report of
both builds is in it.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.prng import kernel as pk  # noqa: E402
from repro_torch.kernels.prng.ref import weak_scalar  # noqa: E402

# opcodes of the integer ALU pipe (the bound's 64 lanes an SM)
ALU = {"IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA", "PRMT", "IMNMX", "VIMNMX", "IABS", "FLO",
       "POPC", "BMSK", "SGXT", "PLOP3", "LOP"}
P, I, F, LL, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong, ctypes.c_uint


def build_old(old: Path):
    out = old / "build"
    out.mkdir(exist_ok=True)
    lib_path = out / "libgumbel_pick_old.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(old / "gumbel_pick.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the earlier gumbel_pick:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.da4ml_gumbel_pick.argtypes = [I, P, I, I, LL, U, U, F, P, P]
    lib.da4ml_gumbel_pick.restype = I
    return lib, lib_path, proc.stdout + proc.stderr


def direct_pick(lib, x, k0, k1, t, splits, scratch):
    """A pick through this tree's C entry point on ``splits`` blocks a row,
    with the device's noise table and ``scratch`` (zero, left zero): the
    kernel alone, without the wrapper's buffers (inside a capture, no
    scratch of the graph's own and no watch on the graph's lifetime)."""
    b, v = x.shape
    bf16 = x.dtype == torch.bfloat16
    t = weak_scalar(t, x.dtype)
    table = pk._noise_tables[x.device.index] if bf16 else None
    out = torch.empty(b, dtype=torch.int64, device=x.device)
    err = lib.da4ml_gumbel_pick(int(bf16), x.data_ptr(), b, v, x.stride(0), k0, k1, t, 1.0 / t,
                                int(pk.exact_division(t)), splits,
                                None if table is None else table.data_ptr(), scratch.data_ptr(),
                                out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the pick failed: cudaError {err}")
    return out


def old_pick(lib, x, k0, k1, t):
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    err = lib.da4ml_gumbel_pick(int(x.dtype == torch.bfloat16), x.data_ptr(), x.shape[0],
                                x.shape[1], x.stride(0), k0, k1, weak_scalar(t, x.dtype),
                                out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the earlier pick failed: cudaError {err}")
    return out


def sass_loops(text: str) -> dict:
    """Per kernel in ``cuobjdump -sass`` output: each loop (the span from a
    backward branch's target to the branch) with its instructions by
    opcode."""
    kernels, name, insts, labels = {}, None, [], {}

    def close():
        if name is None:
            return
        loops = []
        for addr, op, target in insts:
            if op == "BRA" and target is not None:
                to = labels.get(target, target) if isinstance(target, str) else target
                if isinstance(to, int) and to < addr:
                    body = [o for a, o, _ in insts if to <= a <= addr]
                    counts = {}
                    for o in body:
                        counts[o] = counts.get(o, 0) + 1
                    loops.append({"from": hex(to), "to": hex(addr), "instructions": len(body),
                                  "alu": sum(n for o, n in counts.items() if o in ALU),
                                  "by_opcode": dict(sorted(counts.items(), key=lambda kv: -kv[1]))})
        kernels[name] = sorted(loops, key=lambda lp: -lp["instructions"])

    pending = []
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            close()
            name, insts, labels, pending = m.group(1), [], {}, []
            continue
        m = re.match(r"\s*(\.L_x_\d+):", ln)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\S*)\s*(.*)", ln)
        if m and name is not None:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            op, rest = m.group(2), m.group(4)
            target = None
            if op == "BRA":
                t = re.search(r"\((\.L_x_\d+)\)", rest) or re.search(r"0x([0-9a-f]+)", rest)
                if t:
                    target = t.group(1) if t.group(1).startswith(".L") else int(t.group(1), 16)
            insts.append((addr, op, target))
    close()
    return kernels


def sass_of(lib_path: Path, out_dir: Path | None, tag: str) -> dict:
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"gumbel_pick_{tag}.sass").write_text(text)
    return sass_loops(text)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--json", type=Path)
    ap.add_argument("--sass", type=Path, default=None)
    ap.add_argument("--splits", default="")
    ap.add_argument("--floor", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    old_lib, old_path, old_log = build_old(args.old)
    new_path = _build.build_all()["gumbel_pick"]
    result = {"card": smi, "torch": torch.__version__, "sms": _build.sm_count(dev),
              "ptxas": {"old": [ln.strip() for ln in old_log.splitlines() if "ptxas" in ln or
                                "bytes stack" in ln],
                        "new": [ln.strip() for ln in _build.build_log("gumbel_pick").splitlines()
                                if "ptxas" in ln or "bytes stack" in ln]},
              "sass": {"old": sass_of(old_path, args.sass, "old"),
                       "new": sass_of(new_path, args.sass, "new")},
              "logits_per_loop_pass": {"old": 1, "new": pk.PICK_GROUP}, "times": {}}
    for name, (b, v, dtype) in smoke.pick_shapes(torch).items():
        x = smoke.pick_logits(torch, dev, b, v, dtype, 99)
        same = all(torch.equal(old_pick(old_lib, x, k, k + 1, t),
                               pk.gumbel_pick_cuda(x, k, k + 1, t))
                   for k, t in ((1, 0.7), (5, 1.0)))
        plan = pk.pick_plan(b, v, _build.sm_count(dev))
        fns = {"old": lambda: old_pick(old_lib, x, 1, 2, 0.7),
               "new": lambda: pk.gumbel_pick_cuda(x, 1, 2, 0.7)}
        runs = {k: [] for k in fns}
        for which in ("old", "new", "new", "old"):
            runs[which].append(smoke.graph_ms(torch, fns[which]))
        result["times"][name] = {"b": b, "v": v, "dtype": str(dtype)[6:], "same_picks": same,
                                 **{f"{k}_ms": r for k, r in runs.items()},
                                 "plan": plan._asdict()}
        print(name, json.dumps(result["times"][name]), flush=True)
    if args.splits:
        x = smoke.pick_logits(torch, dev, 8, 49152, torch.bfloat16, 99)
        scratch = torch.zeros((8, 2), dtype=torch.int64, device=dev)
        wrapper = lambda: pk.gumbel_pick_cuda(x, 1, 2, 0.7)  # noqa: E731
        result["splits"] = {"wrapper_ms": [smoke.graph_ms(torch, wrapper)]}
        for splits in (int(s) for s in args.splits.split(",")):
            ms = smoke.graph_ms(torch, lambda: direct_pick(pk._pick_lib(), x, 1, 2, 0.7, splits,
                                                           scratch))
            result["splits"][splits] = ms
            print("splits", splits, ms, flush=True)
        result["splits"]["wrapper_ms"].append(smoke.graph_ms(torch, wrapper))
    if args.floor:
        one = torch.zeros(1, device=dev)
        result["floor_ms"] = smoke.graph_ms(torch, lambda: one.add_(1))
        print("floor", result["floor_ms"], flush=True)
    text = json.dumps(result)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(text)
    print(text)
    return 0 if all(r["same_picks"] for r in result["times"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
