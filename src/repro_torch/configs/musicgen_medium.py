"""MusicGen-medium [arXiv:2306.05284; hf] — decoder over EnCodec tokens.

48-layer decoder, d_model 1536, 24 heads (MHA: kv=24), d_ff 6144 (GELU MLP
in the original; we keep the SwiGLU substrate with matched width), vocab
2048 (one EnCodec codebook).  The EnCodec frontend + codebook delay pattern
is a STUB: ``input_specs()`` provides the summed codebook frame embeddings
for the prompt region; generation proceeds token-by-token per codebook.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab=2048,
    frontend_tokens=256,
    source="arXiv:2306.05284",
)
