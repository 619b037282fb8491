"""Problem families. Ported so far: Kirk ch.3 and coupled position+attitude."""

from . import kirk, pos_att

__all__ = ["kirk", "pos_att"]
