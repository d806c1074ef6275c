"""Data parallelism over ``torch.distributed``, one process a rank: the
process group and flat collectives (``collectives``), the DDP and Horovod
gradient synchronisation (``dp``), the sharded Adam update
(``sharded_update``) and a launcher of process-per-rank worlds on one
machine (``launch``)."""
