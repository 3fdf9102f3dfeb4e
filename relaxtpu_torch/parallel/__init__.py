"""Multi-device paths on ``torch.distributed`` (counterpart of
``relaxtpu/parallel/``): the mesh of ranks, video-sharded extraction and
the DP x TP head step.  Start one process per device with ``torchrun``."""
