from .mlv import (  # noqa: F401
    BLOCK_DTYPES,
    MLV_VIDEO_CLASS_RAW,
    MLV_VIDEO_CLASS_FLAG_LJ92,
    MLV_VIDEO_CLASS_FLAG_LZMA,
    FRAME_UNSPECIFIED,
    FRAME_VIDF,
    FRAME_AUDF,
    RawInfo,
    FrameHeaders,
    parse_block,
)
from .index import build_xref, load_idx, save_idx, get_index  # noqa: F401
from .reader import MLVClip, discover_chunks  # noqa: F401
