from .batched_runner import BatchedSlidingWindowRunner  # noqa: F401
from .detector import (FastRCNN, FasterRCNN, HNLRCNN,  # noqa: F401
                       HNMBRCNN, SelsaRCNN)
from .multi_stage import (CascadeRCNN, DoubleHeadRCNN,  # noqa: F401
                          GridRCNN, HybridTaskCascade, MaskRCNN,
                          MaskScoringRCNN, MultiStageEngine)
from .single_stage import (FCOS, FOVEA, RPN,  # noqa: F401
                           RepPointsDetector, RetinaNet, SingleStageDetector,
                           SingleStageEngine)
from .video_runner import SlidingWindowRunner  # noqa: F401
