"""Native codecs (C++ runtime components, loaded via ctypes)."""

from . import lj92  # noqa: F401
