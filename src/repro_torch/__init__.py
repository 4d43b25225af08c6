"""PyTorch/CUDA port of the da4ml serving path.

Same sub-packages as the JAX package ``repro`` (``core``, ``flow``,
``kernels.adder_graph``, ``nn``, ``runtime``), so each module's
counterpart is found by name.  The port imports ``torch`` and numpy and
never ``jax`` or ``repro``: the JAX package is the reference it is held
against in the tests, bit for bit.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; with ``device=None`` and no card they raise.  On the
card every CMVM goes through the hand-written adder-graph kernel
(``kernels/adder_graph/csrc/adder_graph.cu``); a CPU tensor takes the
plain PyTorch version of the same arithmetic.
"""
