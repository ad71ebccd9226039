from .scannet_io import remap_semantic_for_training
from .synthetic import make_synthetic_scene

__all__ = ["make_synthetic_scene", "remap_semantic_for_training"]
