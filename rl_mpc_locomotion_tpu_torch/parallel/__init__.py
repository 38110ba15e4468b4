"""Data parallelism over the env batch: one process a card,
``torch.distributed`` between them."""

from . import mesh  # noqa: F401
