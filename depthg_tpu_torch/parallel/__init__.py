"""Data parallelism of the port: ``dist`` (one process per GPU under
torchrun), ``mesh`` (one replica per device in one process) and the
sharded ``knn``."""
