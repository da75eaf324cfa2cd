from . import metrics  # noqa: F401
from .metrics import log  # noqa: F401
