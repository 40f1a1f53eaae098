"""Multi-GPU bundle adjustment over torch.distributed (counterpart of
orb_slam2_2021_tpu/parallel): landmark-sharded BA steps (`dist_ba`),
process bring-up, per-rank uploads and rank processes (`multihost`), the
cross-process global-BA service the live System drives (`gba_service`),
and banded corridor problems for checks at scale (`corridor`)."""
