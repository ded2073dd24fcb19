"""Data-parallel scaling: the process group (``dist``) and the split of
batches over ranks and serving replicas (``mesh``)."""
