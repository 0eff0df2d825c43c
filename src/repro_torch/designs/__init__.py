"""Benchmark dataflow designs (Stream-HLS-style kernels + DDCF designs,
among them DeepSeek-V2-Lite's MoE layer as a value-routed engine) plus
the seeded random design generator."""

from repro_torch.designs.streamhls import (FAST_DESIGNS, QUICK_DESIGNS,
                                           STREAMHLS_DESIGNS, make_design)
from repro_torch.designs.ddcf import (flowgnn_pna, flowgnn_pna_stream,
                                      mult_by_2)
from repro_torch.designs.molecules import molhiv_stream
from repro_torch.designs.moe import dsv2_lite_moe_stream, routed_moe_stream
from repro_torch.designs.generate import (DesignSpec, GeneratedDesign,
                                          StageSpec, build_design,
                                          generate_design, shrink_spec,
                                          spec_from_seed)

__all__ = ["DesignSpec", "FAST_DESIGNS", "GeneratedDesign", "QUICK_DESIGNS",
           "STREAMHLS_DESIGNS", "StageSpec", "build_design",
           "dsv2_lite_moe_stream", "flowgnn_pna", "flowgnn_pna_stream",
           "generate_design", "make_design", "molhiv_stream", "mult_by_2",
           "routed_moe_stream", "shrink_spec", "spec_from_seed"]
