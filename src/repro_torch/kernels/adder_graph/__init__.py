from .ops import AdderGraphTables, adder_graph_apply, compile_tables

__all__ = ["AdderGraphTables", "adder_graph_apply", "compile_tables"]
