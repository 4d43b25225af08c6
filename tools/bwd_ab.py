"""Time an earlier tree's attention and scan kernels against this tree's on
one card, in turns (earlier, this, this, earlier), at the training path's
backward shapes and the serving path's forward shapes.

    python tools/bwd_ab.py --old DIR [--json OUT]

DIR holds the earlier tree's four sources, ``flash_attention.cu``,
``flash_attention_bwd.cu``, ``ssm_scan.cu`` and ``ssm_scan_bwd.cu`` (for
the tree before the backward redesign: ``git show
984307a:src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu >
DIR/flash_attention.cu``, and so on).  They are built with the port's
nvcc flags into DIR/build and called through their C entry points as that
tree's wrappers called them: there the flash backward recomputed the
log-sum-exp into a scratch of its own and the scan backward took a
scratch of chunk states; the forward entry points had no log-sum-exp or
chunk-state output.  This tree's kernels are called through the port's
wrappers, as the main path calls them.  Each time is device ms per call
by CUDA-graph replay (CUDA events around the replays).  Beside each
time: whether the two trees' forward outputs are the same bits, and the
largest difference of their backward outputs relative to the earlier
tree's (the summation order changed; ``chip_smoke.py`` holds both to the
plain versions).  Prints, and writes to OUT, one JSON object; ptxas's
``-v`` report of every backward kernel of both trees is in it.  Needs a
CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel as sk  # noqa: E402

SOURCES = ("flash_attention", "flash_attention_bwd", "ssm_scan", "ssm_scan_bwd")
P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


def build_old(old: Path) -> tuple[dict, dict]:
    """The earlier sources' libraries (loaded) and ptxas reports."""
    out = old / "build"
    out.mkdir(exist_ok=True)
    procs = {}
    for name in SOURCES:
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
               str(old / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs, logs = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the earlier {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
        logs[name] = log
    libs["flash_attention"].da4ml_flash_attention.argtypes = [
        I, I, I, I, P, P, P, P, I, I, I, I, I, ctypes.POINTER(LL), F, I, P, I, I, P]
    libs["flash_attention_bwd"].da4ml_flash_attention_bwd.argtypes = [
        I, I, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, F, I, I, P]
    libs["ssm_scan"].da4ml_ssm_scan.argtypes = [
        I, P, P, P, P, P, P, P, P, I, I, I, I, LL, LL, LL, LL, P]
    libs["ssm_scan_bwd"].da4ml_ssm_scan_bwd.argtypes = [P] * 15 + [I, I, I, I, P]
    libs["ssm_scan_bwd"].da4ml_ssm_scan_bwd_scratch.argtypes = [I, I, I, I]
    libs["ssm_scan_bwd"].da4ml_ssm_scan_bwd_scratch.restype = LL
    return libs, logs


def ptxas(log: str) -> list[str]:
    keep = []
    for ln in log.splitlines():
        if "Compiling entry" in ln or "registers" in ln or "spill" in ln:
            keep.append(ln.strip())
    return keep


def graph_ms(fn, calls: int, replays: int) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def in_turns(old_fn, new_fn, calls: int = 20, replays: int = 10) -> dict:
    times = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        times[which].append(graph_ms(old_fn if which == "old" else new_fn, calls, replays))
    return {"old_ms": times["old"], "new_ms": times["new"],
            "old_mean_ms": sum(times["old"]) / 2, "new_mean_ms": sum(times["new"]) / 2,
            "new_over_old": sum(times["new"]) / sum(times["old"])}


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"an earlier kernel's launch failed: cudaError {err}")


def flash_bwd_case(libs, b, hq, hkv, s, d) -> dict:
    gen = torch.Generator("cuda").manual_seed(s + d)
    q, do = (torch.randn((b, hq, s, d), generator=gen, device="cuda").bfloat16()
             for _ in range(2))
    k, v = (torch.randn((b, hkv, s, d), generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    lse = torch.empty((b, hq, s), device="cuda")
    o = fk.flash_attention_cuda(q, k, v, lse=lse)
    o_lse, o_delta = torch.empty_like(lse), torch.empty_like(lse)
    old_out = [torch.empty_like(t) for t in (q, k, v)]
    lib = libs["flash_attention_bwd"]

    def old():
        check(lib.da4ml_flash_attention_bwd(
            1, d, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            *(t.data_ptr() for t in old_out), o_lse.data_ptr(), o_delta.data_ptr(), b, hq, hkv,
            s, s, d**-0.5, 1, 0, stream()))

    def new():
        return fk.flash_attention_bwd_cuda(q, k, v, o, do, lse)

    old()
    got = new()
    torch.cuda.synchronize()
    diff = max(float((a.float() - c.float()).abs().max()) / float(c.float().abs().max())
               for a, c in zip(got, old_out))
    plan = fk.flash_bwd_plan(b, hq, hkv, s, s, d, torch.bfloat16)
    return {"shape": f"q/o/dO [{b}, {hq}, {s}, {d}], k/v [{b}, {hkv}, {s}, {d}], bf16, causal",
            "plan": plan._asdict(), "rel_diff_new_vs_old": diff,
            **in_turns(old, new, calls=20 if s <= 256 else 4, replays=10)}


def scan_bwd_case(libs, b, s, d, n) -> dict:
    gen = torch.Generator("cuda").manual_seed(7)
    r = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    args = (torch.nn.functional.softplus(r(b, s, d) - 1), r(b, s, n), r(b, s, n), r(b, s, d),
            -torch.exp(0.5 * r(d, n)), r(b, d, n))
    dy = r(b, s, d)
    hc = torch.empty(sk.chunk_states_shape(b, s, d, n), device="cuda")
    sk.selective_scan_cuda(*args, chunk_states=hc)
    lib = libs["ssm_scan_bwd"]
    scratch = torch.empty(lib.da4ml_ssm_scan_bwd_scratch(b, s, d, n), device="cuda")
    old_out = [torch.empty_like(t) for t in args]

    def old():
        check(lib.da4ml_ssm_scan_bwd(*(t.data_ptr() for t in args), dy.data_ptr(), None,
                                     *(t.data_ptr() for t in old_out), scratch.data_ptr(), b, s,
                                     d, n, stream()))

    def new():
        return sk.selective_scan_bwd_cuda(*args, dy, None, hc)

    old()
    got = new()
    torch.cuda.synchronize()
    diff = max(float((a - c).abs().max()) / float(c.abs().max()) for a, c in zip(got, old_out))
    return {"shape": f"dt/x/dy [{b}, {s}, {d}], B/C [{b}, {s}, {n}], f32",
            "plan": sk.scan_bwd_plan(b, s, d, n)._asdict(), "rel_diff_new_vs_old": diff,
            **in_turns(old, new, calls=5, replays=5)}


def flash_fwd_case(libs, b, hq, hkv, sq, sk_, d, offset) -> dict:
    gen = torch.Generator("cuda").manual_seed(sq + d)
    q = torch.randn((b, hq, sq, d), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((b, hkv, sk_, d), generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    off = torch.tensor([offset], dtype=torch.int32, device="cuda")
    plan = fk.flash_plan(b, hq, hkv, sq, sk_, torch.bfloat16)
    strides = (LL * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    out = torch.empty_like(q)
    lib = libs["flash_attention"]

    def old():
        check(lib.da4ml_flash_attention(
            1, {"decode": 1, "tensor_core": 2}[plan.kernel], plan.splits, d, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv, sq, sk_, strides, d**-0.5, 1,
            off.data_ptr(), 0, 1, stream()))

    def new():
        return fk.flash_attention_cuda(q, k, v, offset=off)

    old()
    same = torch.equal(new(), out)
    return {"shape": f"q [{b}, {hq}, {sq}, {d}], k/v [{b}, {hkv}, {sk_}, {d}], bf16, offset "
                     f"{offset}, {plan.kernel}", "bits_equal": same, **in_turns(old, new)}


def scan_fwd_case(libs, b, s, d, n) -> dict:
    gen = torch.Generator("cuda").manual_seed(5)
    r = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    args = (torch.nn.functional.softplus(r(b, s, d) - 1), r(b, s, n), r(b, s, n), r(b, s, d),
            -torch.exp(0.5 * r(d, n)), r(b, d, n))
    y, h = torch.empty_like(args[0]), torch.empty_like(args[5])
    lib = libs["ssm_scan"]
    kernel = sk.KERNELS.index(sk.scan_kernel_for(s))

    def old():
        check(lib.da4ml_ssm_scan(kernel, *(t.data_ptr() for t in args), y.data_ptr(),
                                 h.data_ptr(), b, s, d, n, s * n, n, s * n, n, stream()))

    def new():
        return sk.selective_scan_cuda(*args)

    old()
    ny, nh = new()
    return {"shape": f"dt/x [{b}, {s}, {d}], N {n}, f32, {sk.scan_kernel_for(s)} (one state, "
                     f"L2-warm at decode)", "bits_equal": torch.equal(ny, y) and torch.equal(nh, h),
            **in_turns(old, new, calls=20 if s == 1 else 5, replays=10)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=Path)
    ap.add_argument("--json", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    libs, old_logs = build_old(args.old)
    _build.build_all()
    bwd = ("flash_attention_bwd", "ssm_scan_bwd")
    out = {"card": smi, "torch": torch.__version__,
           "ptxas": {"old": {k: ptxas(old_logs[k]) for k in bwd},
                     "new": {k: ptxas(_build.build_log(k)) for k in bwd}},
           "flash_bwd": [flash_bwd_case(libs, 8, 9, 3, 128, 64),
                         flash_bwd_case(libs, 16, 9, 3, 1024, 64)],
           "scan_bwd": [scan_bwd_case(libs, 8, 128, 8192, 16)],
           "flash_fwd": [flash_fwd_case(libs, 8, 9, 3, 1, 512, 64, 160),
                         flash_fwd_case(libs, 8, 9, 3, 128, 128, 64, 0),
                         flash_fwd_case(libs, 8, 32, 32, 128, 128, 80, 0),
                         flash_fwd_case(libs, 8, 32, 4, 128, 128, 128, 0)],
           "scan_fwd": [scan_fwd_case(libs, 8, 1, 8192, 16), scan_fwd_case(libs, 8, 128, 8192, 16)]}
    text = json.dumps(out, indent=1)
    print(text)
    if args.json:
        args.json.write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
