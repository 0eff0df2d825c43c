"""Benchmark dataflow designs (Stream-HLS-style kernels + DDCF designs)
plus the seeded random design generator."""

from repro_torch.designs.streamhls import (FAST_DESIGNS, QUICK_DESIGNS,
                                           STREAMHLS_DESIGNS, make_design)
from repro_torch.designs.ddcf import (flowgnn_pna, flowgnn_pna_stream,
                                      mult_by_2)
from repro_torch.designs.molecules import molhiv_stream
from repro_torch.designs.generate import (DesignSpec, GeneratedDesign,
                                          StageSpec, build_design,
                                          generate_design, shrink_spec,
                                          spec_from_seed)

__all__ = ["DesignSpec", "FAST_DESIGNS", "GeneratedDesign", "QUICK_DESIGNS",
           "STREAMHLS_DESIGNS", "StageSpec", "build_design", "flowgnn_pna",
           "flowgnn_pna_stream", "generate_design", "make_design",
           "molhiv_stream", "mult_by_2", "shrink_spec", "spec_from_seed"]
