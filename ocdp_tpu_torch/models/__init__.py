"""Problem families. Ported so far: Kirk ch.3, coupled position+attitude
and the full 6-D attitude solve."""

from . import attitude, kirk, pos_att

__all__ = ["attitude", "kirk", "pos_att"]
