from .instance_eval import S3DIS_INSTANCE_CLASSES, SCANNET_INSTANCE_CLASSES, ScanNetEval
from .s3dis_eval import S3DISEval

__all__ = ["ScanNetEval", "S3DISEval", "SCANNET_INSTANCE_CLASSES", "S3DIS_INSTANCE_CLASSES"]
