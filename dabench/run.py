"""One run of one cell of the port's benchmark.

    python3 dabench/run.py --workload mixer_bulk --seed 7 --seconds 10 --trace 0

Prints the result as one JSON line, last on standard output, and the
numbers compared with the reference, each beside its limit, last on
standard error.  Exits non-zero, printing no result, without as many
CUDA cards as the cell asks for, or where the process holds JAX or the
JAX package once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# fixed cache directories inside the checkout, for any toolchain that caches kernels
# (the port's own libraries live in src/repro_torch/_build)
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / ".dabench_cache" / sub)
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from dabench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), t_start=T_START)
    foreign = harness.foreign_modules()
    if foreign:
        print(f"the process holds {', '.join(foreign)} after the window", file=sys.stderr)
        return 4
    print(json.dumps(result))
    sys.stdout.flush()
    print("setup_phases_s " + " ".join(f"{k} {v:.4f}" for k, v in result["setup_phases_s"].items()),
          file=sys.stderr)
    print(f"checked_outputs {result['checked_outputs']}", file=sys.stderr)
    for name, c in result["check"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
