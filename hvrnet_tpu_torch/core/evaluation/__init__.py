from .class_names import (cityscapes_classes, coco_classes, dataset_aliases,
                          get_classes, imagenet_det_classes,
                          imagenet_vid_classes, voc_classes,
                          wider_face_classes)
from .mean_ap import (analysis_map, average_precision, bbox_overlaps_np,
                      eval_map, get_cls_results, print_map_summary,
                      tpfp_analysis, tpfp_default, tpfp_imagenet)

__all__ = [
    "average_precision", "eval_map", "get_cls_results", "print_map_summary",
    "tpfp_default", "tpfp_imagenet", "tpfp_analysis", "analysis_map",
    "bbox_overlaps_np", "get_classes", "dataset_aliases", "voc_classes",
    "coco_classes", "imagenet_vid_classes", "imagenet_det_classes",
    "wider_face_classes", "cityscapes_classes",
]
