from ..utils.registry import Registry

BACKBONES = Registry("backbone")
NECKS = Registry("neck")
SHARED_HEADS = Registry("shared_head")
HEADS = Registry("head")
DETECTORS = Registry("detector")
LOSSES = Registry("loss")
