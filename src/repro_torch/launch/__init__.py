"""Command-line entry points of the port: ``python -m
repro_torch.launch.campaign`` (cross-design DSE campaigns), ``python -m
repro_torch.launch.fuzz`` (differential design-space fuzzing) and
``python -m repro_torch.launch.serve`` (the advisory service over JSON
lines).  They run their tensor backends on the CUDA device unless given
``--device cpu``."""
