"""Train steps over SOL models and the partition rules of sharded serving
(counterpart of ``repro.distributed``; the backbone stack's sharded steps
wait for it)."""
