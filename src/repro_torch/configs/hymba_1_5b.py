"""Hymba-1.5B [arXiv:2411.13676; hf] — hybrid-head: parallel attn + SSM.

Every block runs GQA attention (25 heads, kv=5) and a Mamba head bank in
PARALLEL on the same input; per-path RMSNorm then mean fusion.  Most layers
use sliding-window attention (window 1024); every 8th layer (and the last)
is global — giving sub-quadratic long-context decode (long_500k runs).
ssm_state=16 per the assignment.
"""

from repro_torch.configs.base import ArchConfig, SsmConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001, head_dim=64,
    hybrid_ssm=True,
    sliding_window=1024, global_attn_every=8,
    ssm=SsmConfig(d_state=16, d_conv=4, expand=2, head_dim=50, chunk=256),
    source="arXiv:2411.13676",
)
