from .ops import AdderGraphTables, Epilogue, adder_graph_apply, compile_tables, epilogue_table

__all__ = ["AdderGraphTables", "Epilogue", "adder_graph_apply", "compile_tables", "epilogue_table"]
