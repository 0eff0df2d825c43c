"""Architecture + shape configuration system.

Every assigned architecture is an :class:`ArchConfig` instance in its own
module (``repro_torch/configs/<id>.py``), selectable by ``--arch <id>`` in the
launchers.  ``reduced()`` yields the family-preserving small config used by
the CPU tests and the decode demo; ``chip_smoke.py`` also runs qwen2-1.5b
at its full width on the card.  The fields are a copy of the reference
package's, so ``dataclasses.asdict`` of every config equals its.

Input shapes (identical for every LM arch, per the assignment):

    train_4k     seq 4096,  global_batch 256   (train_step)
    prefill_32k  seq 32768, global_batch 32    (serve prefill)
    decode_32k   seq 32768, global_batch 128   (serve decode: 1 new token)
    long_500k    seq 524288, global_batch 1    (decode; sub-quadratic only)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0
    first_k_dense: int = 0          # leading layers that use a dense FFN
    d_ff_dense: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MlaConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SsmConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoeConfig] = None
    mla: Optional[MlaConfig] = None
    ssm: Optional[SsmConfig] = None
    # hybrid (Hymba): parallel attention+SSM heads, sliding-window attn
    hybrid_ssm: bool = False
    sliding_window: int = 0         # 0 = full attention
    global_attn_every: int = 0      # hybrid: every k-th layer is global
    # modality frontend stub: number of precomputed embedding tokens
    frontend_tokens: int = 0
    # MiniCPM-style scaling tricks
    embed_scale: float = 1.0
    residual_scale: float = 1.0
    logit_scale: float = 1.0
    # notes for DESIGN.md / roofline
    source: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def subquadratic(self) -> bool:
        """Can this arch run long_500k? (constant-state or windowed attn)"""
        return self.family == "ssm" or (self.hybrid_ssm
                                        and self.sliding_window > 0)

    def supports_shape(self, shape: str) -> bool:
        if shape == "long_500k":
            return self.subquadratic
        return shape in SHAPES

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, L = self.d_model, self.n_layers
        hd = self.head_dim_
        p = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            per_layer = d * (2 * d_in + 2 * s.d_state + d_in // s.head_dim) \
                + d_in * d + d_in * s.d_conv
        else:
            if self.mla is not None:
                m = self.mla
                q_dim = self.n_heads * (m.nope_head_dim + m.rope_head_dim)
                per_layer = (d * m.q_lora_rank + m.q_lora_rank * q_dim
                             + d * (m.kv_lora_rank + m.rope_head_dim)
                             + m.kv_lora_rank * self.n_heads
                             * (m.nope_head_dim + m.v_head_dim)
                             + self.n_heads * m.v_head_dim * d)
            else:
                per_layer = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                    + self.n_heads * hd * d
            if self.hybrid_ssm:
                s = self.ssm
                d_in = s.expand * d
                per_layer += d * (2 * d_in + 2 * s.d_state
                                  + d_in // s.head_dim) + d_in * d
            if self.moe is not None:
                mo = self.moe
                per_layer += d * mo.n_experts          # router
                per_layer += mo.n_experts * 3 * d * mo.d_ff_expert
                per_layer += mo.n_shared * 3 * d * mo.d_ff_shared
            else:
                per_layer += 3 * d * self.d_ff
        return int(p + L * per_layer)

    def n_active_params(self) -> int:
        """Parameters touched per token (MoE: only routed-active experts)."""
        if self.moe is None:
            return self.n_params()
        mo = self.moe
        d, L = self.d_model, self.n_layers
        inactive = (mo.n_experts - mo.top_k) * 3 * d * mo.d_ff_expert
        return int(self.n_params() - L * inactive)

    def reduced(self) -> "ArchConfig":
        """Family-preserving small config for CPU smoke tests."""
        def shrink_moe(m: Optional[MoeConfig]) -> Optional[MoeConfig]:
            if m is None:
                return None
            return dataclasses.replace(
                m, n_experts=min(8, m.n_experts), top_k=min(2, m.top_k),
                d_ff_expert=32, n_shared=min(1, m.n_shared), d_ff_shared=32,
                first_k_dense=min(1, m.first_k_dense), d_ff_dense=64)

        def shrink_mla(m: Optional[MlaConfig]) -> Optional[MlaConfig]:
            if m is None:
                return None
            return MlaConfig(kv_lora_rank=16, q_lora_rank=24,
                             rope_head_dim=8, nope_head_dim=16, v_head_dim=16)

        def shrink_ssm(s: Optional[SsmConfig]) -> Optional[SsmConfig]:
            if s is None:
                return None
            return SsmConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                             chunk=32)

        return dataclasses.replace(
            self,
            n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=min(self.n_kv_heads, 2) or 2,
            d_ff=128, vocab=512, head_dim=16,
            moe=shrink_moe(self.moe), mla=shrink_mla(self.mla),
            ssm=shrink_ssm(self.ssm),
            sliding_window=min(self.sliding_window, 32)
            if self.sliding_window else 0,
            frontend_tokens=min(self.frontend_tokens, 8),
        )
