from .config import ProcessingConfig  # noqa: F401
from .convert import convert_clip, ClipConverter  # noqa: F401
