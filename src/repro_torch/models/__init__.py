"""Model zoo substrate: composable decoder blocks for all assigned archs
(plain torch ops; served on one device)."""

from repro_torch.models.transformer import (block_specs, forward, init_cache,
                                            model_specs)

__all__ = ["block_specs", "forward", "init_cache", "model_specs"]
