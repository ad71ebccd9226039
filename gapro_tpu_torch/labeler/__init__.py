from .boxes import floor_box, instance_info, wall_boxes_from_planes
from .pipeline import (
    LabelerConfig,
    generate_scene_labels,
    generate_scene_labels_stream,
    resolve_scene,
    submit_scene,
    submit_scenes_batched,
)

__all__ = [
    "instance_info",
    "floor_box",
    "wall_boxes_from_planes",
    "LabelerConfig",
    "generate_scene_labels",
    "generate_scene_labels_stream",
    "submit_scene",
    "submit_scenes_batched",
    "resolve_scene",
]
