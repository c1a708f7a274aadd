"""Train steps over SOL models (counterpart of ``repro.distributed``;
the mesh, sharding and serve steps wait for sharded serving)."""
