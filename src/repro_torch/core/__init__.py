"""da4ml core: distributed-arithmetic CMVM optimization (the paper's
primary contribution), hardware-independent host code (numpy).

A copy of the JAX package's ``core`` (which imports no JAX here either):
the same solver, bit for bit, so a solve in either package gives the
same DAIS program, the same cache key and an interchangeable disk-cache
entry.

Public API:
    solve_cmvm        two-stage da4ml optimizer -> Solution (DAIS program)
    naive_adder_tree  hls4ml 'latency'-strategy baseline in the same units
    QInterval         quantized-interval fixed-point bookkeeping
    DAISProgram/Term  SSA shift-add IR
    decompose         stage-1 graph decomposition (M = M1 @ M2)
    pipeline          greedy register insertion
    emit_verilog      standalone RTL generation
    parse_verilog     netlist parser for the emitted subset
    RTLSimulator      cycle-accurate pure-Python RTL simulation
    cosim_grid        RTL == DAIS interpreter == adder-graph kernel gate
"""

from .cache import CacheStats, SolutionCache, pack_solution, solve_key, unpack_solution
from .csd import csd_nnz, csd_span, from_csd, to_csd, vector_csd_nnz
from .cosim import cosim_case, cosim_grid, cosim_program, default_grid
from .cost import adder_cost, ceil_log2, min_tree_depth, min_tree_depth_hist, overlap_bits
from .cse import CSE
from .dais import (
    KIND_ADD,
    KIND_INPUT,
    KIND_NEG,
    DAISProgram,
    Row,
    Term,
    qints_from_array,
    qints_to_array,
)
from .fixed_point import QInterval
from .graph_decompose import Decomposition, decompose
from .pipelining import PipelineReport, pipeline
from .rtlsim import RTLModule, RTLSimError, RTLSimulator, SimResult, parse_verilog
from .solver import Solution, config_solve_key, naive_adder_tree, solve_cmvm
from .verilog import emit_verilog

__all__ = [
    "CSE",
    "KIND_ADD",
    "KIND_INPUT",
    "KIND_NEG",
    "CacheStats",
    "DAISProgram",
    "Decomposition",
    "PipelineReport",
    "QInterval",
    "RTLModule",
    "RTLSimError",
    "RTLSimulator",
    "Row",
    "SimResult",
    "Solution",
    "SolutionCache",
    "Term",
    "adder_cost",
    "ceil_log2",
    "config_solve_key",
    "cosim_case",
    "cosim_grid",
    "cosim_program",
    "csd_nnz",
    "csd_span",
    "decompose",
    "default_grid",
    "emit_verilog",
    "from_csd",
    "min_tree_depth",
    "min_tree_depth_hist",
    "naive_adder_tree",
    "overlap_bits",
    "pack_solution",
    "parse_verilog",
    "pipeline",
    "qints_from_array",
    "qints_to_array",
    "solve_cmvm",
    "solve_key",
    "to_csd",
    "unpack_solution",
    "vector_csd_nnz",
]
