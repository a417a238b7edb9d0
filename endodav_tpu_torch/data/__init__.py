from .c3vd import C3VDFrames
from .hamlyn import HamlynFrames, HamlynVideos
from .loader import Loader, readlines
from .scared import ScaredFrames, ScaredVideoClips, ScaredVideos

__all__ = [
    "C3VDFrames",
    "HamlynFrames",
    "HamlynVideos",
    "Loader",
    "readlines",
    "ScaredFrames",
    "ScaredVideoClips",
    "ScaredVideos",
]
