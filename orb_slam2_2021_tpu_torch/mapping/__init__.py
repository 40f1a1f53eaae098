"""Map data model: the host-side keyframe / map-point store (the port's own
copy of orb_slam2_2021_tpu/mapping)."""

from .map_store import MapStore

__all__ = ["MapStore"]
