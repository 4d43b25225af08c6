"""Pipelining of DAIS programs (paper §5.2).

A DAIS program describes a combinational circuit.  Registers are inserted
greedily whenever the accumulated estimated delay along a path exceeds a
user threshold: each adder is assumed to cost one delay unit by default
(routing dominates on FPGAs, §3), and the threshold `max_delay_per_stage`
expresses how many adder levels fit in one clock period.

The algorithm is local and greedy, exactly as in the paper: stage(u) =
max over operands of (stage(op) + carry), where a value is re-registered
when its combinational depth within the current stage would exceed the
threshold.  Register (FF) cost is the bitwidth of every value crossing a
stage boundary, including inputs carried forward for later consumers.
"""

from __future__ import annotations

from dataclasses import dataclass

from .dais import KIND_INPUT, DAISProgram


@dataclass
class PipelineReport:
    n_stages: int
    stage_of_row: list[int]
    intra_depth: list[int]
    ff_bits: int
    latency_cycles: int

    @property
    def ii(self) -> int:
        return 1  # fully pipelined, one new input per cycle


def pipeline(prog: DAISProgram, max_delay_per_stage: int = 5) -> PipelineReport:
    n = len(prog.rows)
    stage = [0] * n
    intra = [0] * n  # adder depth within the assigned stage
    for i, r in enumerate(prog.rows):
        if r.kind == KIND_INPUT:
            stage[i], intra[i] = 0, 0
            continue
        ops = [r.a] if r.b < 0 else [r.a, r.b]
        s = max(stage[o] for o in ops)
        d = 1 + max((intra[o] if stage[o] == s else 0) for o in ops)
        if d > max_delay_per_stage:
            s, d = s + 1, 1
        stage[i], intra[i] = s, d

    out_rows = [t.row for t in prog.outputs if t is not None]
    n_stages = (max((stage[i] for i in out_rows), default=0)) + 1

    # FF cost: every value alive across a stage boundary is registered at
    # each boundary it crosses (width bits per boundary).
    last_use = [stage[i] for i in range(n)]
    for i, r in enumerate(prog.rows):
        if r.kind != KIND_INPUT:
            for o in ([r.a] if r.b < 0 else [r.a, r.b]):
                last_use[o] = max(last_use[o], stage[i])
    for t in prog.outputs:
        if t is not None:
            # max, not assignment: a row can be consumed by an op in a
            # later stage than any output; its carry registers still cost
            # FF bits (mirrors the emission rule in verilog.py)
            last_use[t.row] = max(last_use[t.row], n_stages - 1)
    ff = 0
    for i, r in enumerate(prog.rows):
        crossings = max(last_use[i] - stage[i], 0)
        ff += crossings * r.qint.width
    return PipelineReport(n_stages, stage, intra, ff, n_stages - 1)
