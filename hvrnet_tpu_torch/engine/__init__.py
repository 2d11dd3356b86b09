from .detector import HNMBRCNN  # noqa: F401
from .video_runner import SlidingWindowRunner  # noqa: F401
