"""Headless visualization of the port (counterpart of
orb_slam2_2021_tpu/viz): the upstream system draws with Pangolin and OpenCV
windows; here the tracked-feature overlay (`FrameDrawer`), the top-down map
view (`MapDrawer`) and the `Viewer` that composes them rasterize to numpy
RGB images and PNG files through the numpy rasterizer of `draw`, which the
offline map processor also writes its PGM grid through."""

from .frame_drawer import FrameDrawer
from .map_drawer import MapDrawer
from .viewer import Viewer

__all__ = ["FrameDrawer", "MapDrawer", "Viewer"]
