"""PyTorch/CUDA port of the da4ml serving path, of the LM serving path
of the dense and SSM families, and of the W8A8 matmul op.

Same sub-packages as the JAX package ``repro`` (``core``, ``flow``,
``kernels.adder_graph``, ``nn``, ``runtime``; ``configs``,
``kernels.flash_attention``, ``kernels.ssm_scan``,
``kernels.quant_matmul``, ``models``, ``serve``), so each module's
counterpart is found by name.  The port imports ``torch`` and numpy and
never ``jax`` or ``repro``: the JAX package is the reference it is held
against in the tests, bit for bit where the reference is integer.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; with ``device=None`` and no card they raise.  On the
card every CMVM goes through the hand-written adder-graph kernel
(``kernels/adder_graph/csrc/adder_graph.cu``), every attention layer
through the hand-written flash-attention kernel
(``kernels/flash_attention/csrc/flash_attention.cu``), every Mamba-1
recurrence through the hand-written selective-scan kernel
(``kernels/ssm_scan/csrc/ssm_scan.cu``) and the W8A8 op through the
hand-written int8 matmul kernel
(``kernels/quant_matmul/csrc/quant_matmul.cu``); a CPU tensor takes the
plain PyTorch version of the same arithmetic.
"""
