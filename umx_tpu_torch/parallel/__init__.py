"""Scale-out past one process (counterpart of ``umx_tpu.parallel``):
``multihost`` partitions a track list over processes and gathers their
metrics with ``torch.distributed``."""
