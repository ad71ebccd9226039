# Frozen copy of gapro_tpu_torch/losses/__init__.py; it does not follow later changes
# to the port.
from .criterion import CriterionConfig, build_targets, isbnet_loss
from .matcher import hungarian_match

__all__ = ["CriterionConfig", "isbnet_loss", "build_targets", "hungarian_match"]
