"""Command-line entry points of the port: ``python -m
repro_torch.launch.campaign`` (cross-design DSE campaigns), ``python -m
repro_torch.launch.fuzz`` (differential design-space fuzzing) and
``python -m repro_torch.launch.serve`` (the advisory service over JSON
lines) and ``python -m repro_torch.launch.decode_demo`` (the LLM prefill
and decode demo).  They run on the CUDA device unless given ``--device
cpu``.  :mod:`.mesh` builds the device meshes that ``--shards`` and
``MeshBackend`` shard rows over."""
