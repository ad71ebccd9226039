from .criterion import CriterionConfig, build_targets, isbnet_loss
from .matcher import hungarian_match

__all__ = ["CriterionConfig", "isbnet_loss", "build_targets", "hungarian_match"]
