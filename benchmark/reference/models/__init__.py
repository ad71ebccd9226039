# Frozen copy of gapro_tpu_torch/models/__init__.py; it does not follow later changes
# to the port.
from .inference import TestConfig, get_instances
from .isbnet import ISBNet, ISBNetConfig, VoxelBatch

__all__ = ["ISBNet", "ISBNetConfig", "TestConfig", "VoxelBatch", "get_instances"]
