# importing the modules registers them for the config builders
from . import losses, mask_heads  # noqa: F401
from .anchor_heads import dense_heads, rpn_head  # noqa: F401
from .backbones import resnet, resnext  # noqa: F401
from .bbox_heads import (bbox_head, convfc_bbox_head,  # noqa: F401
                         hrnmp_bbox_head, selsa_bbox_head)
from .builder import build_model_module, build_roi_extractor  # noqa: F401
from .necks import fpn  # noqa: F401
from .shared_heads import res_layer  # noqa: F401
