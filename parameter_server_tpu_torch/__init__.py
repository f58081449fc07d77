"""PyTorch/CUDA port of the parameter server (first slice: the sparse-LR loop).

The JAX package ``parameter_server_tpu`` is the reference; this package keeps
its module layout and names so each counterpart sits at the same path.  It
imports ``torch`` and numpy only.  Every entry point takes a ``device``
argument that defaults to ``"cuda"``; the CPU is used only when the caller
passes ``device="cpu"``.  On a CUDA tensor the four row kernels of
``ops/scatter.py`` always launch the hand-written CUDA kernels in ``csrc/``.
"""
