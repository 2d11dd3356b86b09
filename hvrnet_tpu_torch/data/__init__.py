from .pipelines import Compose, build_transform
from .resize import resize_bilinear_f32, resize_bilinear_u8
from .vid_dataset import (DATASETS, VID_CLASSES, VID_WNIDS, ConcatDataset,
                          DETSeqDataset, RepeatDataset, VIDSeqDataset,
                          build_dataset, parse_vid_xml)

__all__ = ["Compose", "build_transform", "resize_bilinear_f32",
           "resize_bilinear_u8", "DATASETS", "VID_CLASSES", "VID_WNIDS",
           "ConcatDataset", "DETSeqDataset", "RepeatDataset",
           "VIDSeqDataset", "build_dataset", "parse_vid_xml"]
