"""PyTorch/CUDA port of the ``repro`` conjunctive-query engine.

Each module mirrors one file of ``src/repro/`` and names it in its
docstring.  The port imports torch, numpy and the standard library only; its
hand-written Hopper kernels live in ``repro_torch/kernels/csrc``.
"""
