"""Scale-out past one device (counterpart of ``umx_tpu.parallel``):
``mesh`` and ``sharding`` spread a batch over a grid of devices driven by
one process, ``multihost`` partitions a track list over processes and
gathers their metrics with ``torch.distributed``."""
