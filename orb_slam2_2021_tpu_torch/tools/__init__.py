"""Offline tooling of the port (counterpart of orb_slam2_2021_tpu/tools):
saved-map post-processing (`map_processor`) and chessboard camera
calibration (`calibration`)."""
