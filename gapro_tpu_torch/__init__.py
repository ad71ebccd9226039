"""PyTorch / CUDA port of ``gapro_tpu`` for one NVIDIA H100.

The package mirrors the layout and names of the JAX package (``core/``,
``ops/``, ``sparse/``, ``models/``), imports only ``torch``, numpy and the
standard library, and keeps the JAX package's contracts: the same static
capacities, padding, validity masks, layouts and ``ovf_*`` counters, so a
test can hand both packages the same numpy arrays and weights.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without that argument they raise. Each kernel written
for Hopper lives in ``csrc/`` beside its plain PyTorch version, which the
wrapper takes only for tensors that lie on the CPU.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
