"""FIFOAdvisor on PyTorch and CUDA: the port of the ``repro`` package.

Same layout as the reference package (``core/``, ``core/backends/``,
``designs/``, ``kernels/fifo_eval/``); the two Pallas TPU kernels become
hand-written CUDA kernels for Hopper (``csrc/``), built with ``nvcc`` at
first use.  Entry points run on the CUDA device unless the caller passes
``device="cpu"`` or picks ``backend="numpy"``::

    from repro_torch.core import EvalConfig, FifoAdvisor
    from repro_torch.designs import make_design
    adv = FifoAdvisor(make_design("gemm"), EvalConfig(backend="cuda"))
    adv.run("grouped_sa", budget=1000, seed=0).frontier_points
"""

__version__ = "0.1.0"
