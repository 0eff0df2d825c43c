"""Command-line entry points of the port: ``python -m
repro_torch.launch.campaign`` (cross-design DSE campaigns) and ``python -m
repro_torch.launch.fuzz`` (differential design-space fuzzing).  Both run
their tensor backends on the CUDA device unless given ``--device cpu``."""
