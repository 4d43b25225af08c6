"""The readings that set the limit of ``mismatched_outputs``, on the card.

    python3 dabench/control.py --workload mixer_bulk --seeds 11,12,13 --seconds 2

For each seed, in one process (the design loaded once): one run of the
cell with the program, and one with the control in the program's place,
the plain reference computed in bfloat16 (``reference/network.py``),
through the same driver at the cell's own sizes and load.  The design's
values fit float32's 24 bits, so float32 would still be exact; bfloat16
is the next precision below.  Prints one JSON line a run.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def control_forward(cell, device):
    """The reference in bfloat16, as a drop-in for ``forward_int``."""
    import torch

    from dabench.harness import ROOT as root
    from dabench.reference import network

    ref = network.load(cell.config, root, device=device, dtype=torch.bfloat16)
    return lambda x: ref.on_device(x).to(torch.int32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import torch

    from dabench import harness
    from repro_torch.runtime import load_design

    dev = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    design = load_design(ROOT / cell.config["asset"], device=dev)
    control = control_forward(cell, dev)
    for seed in (int(s) for s in args.seeds.split(",")):
        for side, fwd in (("program", None), ("control", control)):
            t = time.perf_counter()
            r = harness.run_cell(cell, seed, args.seconds, False, dev, design=design, forward=fwd)
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side,
                              "correct": r["correct"], "checked_outputs": r["checked_outputs"],
                              "mismatched_outputs": r["check"]["mismatched_outputs"]["value"],
                              "calls": r["attempted"], "s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
