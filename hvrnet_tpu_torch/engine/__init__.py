from .batched_runner import BatchedSlidingWindowRunner  # noqa: F401
from .detector import HNLRCNN, HNMBRCNN, SelsaRCNN  # noqa: F401
from .video_runner import SlidingWindowRunner  # noqa: F401
