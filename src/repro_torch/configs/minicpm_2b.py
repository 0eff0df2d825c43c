"""MiniCPM-2B [arXiv:2404.06395; hf] — llama-like dense + WSD schedule.

MiniCPM's training tricks are reflected here: scaled embeddings
(``embed_scale=12``), depth-scaled residual branches
(``1.4 / sqrt(n_layers)``), and logits scaled by ``1/(d_model/256)``.
The WSD learning-rate schedule is selected in train/optimizer.py when
``schedule="wsd"`` (launch/train.py picks it for this arch).
"""

import math

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
    d_ff=5760, vocab=122753, tie_embeddings=True,
    embed_scale=12.0,
    residual_scale=1.4 / math.sqrt(40),
    logit_scale=256.0 / 2304.0,
    source="arXiv:2404.06395",
)
