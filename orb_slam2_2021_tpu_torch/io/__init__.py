"""I/O of the port: synthetic sequences, trajectory export, map files and
per-frame metrics (own copies of the reference's host code)."""
