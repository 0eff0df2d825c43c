"""Batched FIFO-configuration latency evaluation (hand-written CUDA kernels).

``fifo_eval.py``  K2 wrapper: the raw-stream fixpoint (``csrc/fifo_eval.cu``).
``condensed.py``  K1 wrapper: fused condensed fixpoint + certificate
                  (``csrc/condensed.cu``).
``ref.py``        plain torch versions of both, with identical results.
``ops.py``        closures: SimGraph -> padded event tensors -> kernel.
``build.py``      nvcc build and ctypes loading of the kernel library.

Importing this package never builds or loads CUDA code; the first launch
on a CUDA tensor does.  Import the wrappers from their modules (the
package exports no names, so ``fifo_eval`` here is always the module).
"""
