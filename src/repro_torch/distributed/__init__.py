"""Train and serve steps, the partition rules of sharded serving and of
the backbone, and the collectives of the backbone's per-rank program
(counterpart of ``repro.distributed``)."""
