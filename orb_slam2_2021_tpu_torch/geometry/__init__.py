"""Lie-group and camera geometry (counterpart of orb_slam2_2021_tpu.geometry)."""
