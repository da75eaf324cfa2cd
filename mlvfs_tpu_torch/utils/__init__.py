from .metrics import StageTimer, metrics, log  # noqa: F401
