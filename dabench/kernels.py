"""The program's kernel names, as the profiler reports them."""


def is_adder_graph(name: str) -> bool:
    """The adder-graph kernel (``kernels/adder_graph/csrc/adder_graph.cu``,
    its shared-memory and global-scratch entries)."""
    return "adder_graph_" in name
