"""Headless visualization of the port (counterpart of
orb_slam2_2021_tpu/viz): for now the numpy rasterizer and image writers of
`draw`, which the offline map processor writes its PGM grid through."""
