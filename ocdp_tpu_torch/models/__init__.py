"""Problem families: Kirk ch.3, coupled position+attitude, position, and
attitude (the per-axis simplified solve and the full 6-D solve)."""

from . import attitude, kirk, pos_att, position

__all__ = ["attitude", "kirk", "pos_att", "position"]
