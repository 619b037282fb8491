"""Problem families. Ported so far: Kirk ch.3."""

from . import kirk

__all__ = ["kirk"]
