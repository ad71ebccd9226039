from .inference import TestConfig, get_instances
from .isbnet import ISBNet, ISBNetConfig, VoxelBatch

__all__ = ["ISBNet", "ISBNetConfig", "TestConfig", "VoxelBatch", "get_instances"]
