"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — MoE 128 experts top-8, GQA kv=4."""

from repro_torch.configs.base import ArchConfig, MoeConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab=151936, head_dim=128,
    rope_theta=1_000_000.0,
    moe=MoeConfig(n_experts=128, top_k=8, d_ff_expert=768),
    source="hf:Qwen/Qwen3-30B-A3B",
)
