"""InternVL2-2B [arXiv:2404.16821; hf] — InternViT frontend + InternLM2-1.8B.

The assigned backbone is the InternLM2-1.8B decoder; the InternViT vision
tower is a STUB per the assignment: ``input_specs()`` supplies 256
precomputed patch embeddings per sample (the 448x448 pixel-unshuffled tile)
which the backbone consumes as a prefix.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92553,
    rope_theta=1_000_000.0,
    frontend_tokens=256,
    source="arXiv:2404.16821",
)
