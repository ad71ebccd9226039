"""The benchmark's plain reference: plain PyTorch and numpy, float32.

Each module is a frozen copy of the port's module of the same path under
``gapro_tpu_torch/`` (named on its first line), with every hand-written
kernel taken out: the sparse convs (``sparse/conv.py``), furthest point
sampling (``ops/fps.py``) and the dynamic-conv mask head
(``models/dyco.py``) run their plain versions. It imports nothing of the
port, of the JAX package or of JAX, so that a later change to the port
cannot move it.
"""
