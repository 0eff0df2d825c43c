"""DeepSeek-V2 236B [arXiv:2405.04434; hf] — MLA + MoE 160e top-6.

MLA: kv_lora_rank=512, q_lora_rank=1536, decoupled RoPE head 64,
nope/v head dims 128.  MoE: 2 shared + 160 routed experts (top-6),
expert FFN width 1536; the first layer uses a dense FFN (width 12288).
"""

from repro_torch.configs.base import ArchConfig, MlaConfig, MoeConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=12288, vocab=102400,
    mla=MlaConfig(kv_lora_rank=512, q_lora_rank=1536,
                  rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
    moe=MoeConfig(n_experts=160, top_k=6, d_ff_expert=1536,
                  n_shared=2, d_ff_shared=1536,
                  first_k_dense=1, d_ff_dense=12288),
    source="arXiv:2405.04434",
)
