"""Names shared with the JAX package's device-mesh code (one card here)."""

from . import mesh  # noqa: F401
