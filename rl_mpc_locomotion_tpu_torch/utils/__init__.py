"""Converters between the JAX package's state containers and the port's."""

from . import convert  # noqa: F401
