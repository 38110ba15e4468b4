"""Robot constants."""

from . import robots  # noqa: F401
