"""Assigned-architecture registry: ``--arch <id>`` resolves here.

The paper (FIFOAdvisor) contributes an EDA algorithm, not a network
architecture; its "own configs" are the Stream-HLS dataflow designs in
:mod:`repro_torch.designs`.  The LM pool below exercises the distributed
substrate (models, sharding, dry-run, roofline).
"""

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig

from repro_torch.configs.qwen2_1_5b import CONFIG as _qwen2_1_5b
from repro_torch.configs.internlm2_1_8b import CONFIG as _internlm2_1_8b
from repro_torch.configs.qwen2_7b import CONFIG as _qwen2_7b
from repro_torch.configs.minicpm_2b import CONFIG as _minicpm_2b
from repro_torch.configs.deepseek_v2_236b import CONFIG as _deepseek_v2_236b
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as _qwen3_moe
from repro_torch.configs.mamba2_1_3b import CONFIG as _mamba2_1_3b
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba_1_5b
from repro_torch.configs.internvl2_2b import CONFIG as _internvl2_2b
from repro_torch.configs.musicgen_medium import CONFIG as _musicgen_medium

ARCHS = {
    c.name: c for c in [
        _qwen2_1_5b, _internlm2_1_8b, _qwen2_7b, _minicpm_2b,
        _deepseek_v2_236b, _qwen3_moe, _mamba2_1_3b, _hymba_1_5b,
        _internvl2_2b, _musicgen_medium,
    ]
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "SHAPES", "ArchConfig", "ShapeConfig", "get_arch"]
