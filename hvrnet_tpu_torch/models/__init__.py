# importing the modules registers them for the config builders
from .anchor_heads import rpn_head  # noqa: F401
from .backbones import resnet  # noqa: F401
from .bbox_heads import hrnmp_bbox_head, selsa_bbox_head  # noqa: F401
from .builder import build_model_module, build_roi_extractor  # noqa: F401
from .shared_heads import res_layer  # noqa: F401
