"""Mamba2-1.3B [arXiv:2405.21060] — attention-free SSD (state-space duality).

48 blocks, d_model 2048, d_state 128, expand 2 (d_inner 4096), head_dim 64
(64 SSD heads), conv width 4.  Runs long_500k (constant-size state).
"""

from repro_torch.configs.base import ArchConfig, SsmConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=64, n_kv_heads=0,
    d_ff=0, vocab=50280,
    ssm=SsmConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    source="arXiv:2405.21060",
)
