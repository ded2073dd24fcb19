"""Scaling over processes: the process group and its mesh groups
(``dist``), the split of batches over ranks and serving replicas and the
tensor-parallel rules (``mesh``), and the split model (``tensor``)."""
