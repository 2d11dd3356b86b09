from .batched_runner import BatchedSlidingWindowRunner  # noqa: F401
from .detector import (FastRCNN, FasterRCNN, HNLRCNN,  # noqa: F401
                       HNMBRCNN, SelsaRCNN)
from .multi_stage import (CascadeRCNN, DoubleHeadRCNN,  # noqa: F401
                          GridRCNN, HybridTaskCascade, MaskRCNN,
                          MaskScoringRCNN, MultiStageEngine)
from .video_runner import SlidingWindowRunner  # noqa: F401
