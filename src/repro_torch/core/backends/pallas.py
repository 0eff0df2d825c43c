"""Kernel backend: the hand-written CUDA kernels behind the shared
operand/dispatch machinery (the reference package's ``PallasBackend``,
which this registry entry also answers to as ``"pallas"`` so reference
``EvalConfig`` dicts load unchanged).

Two kernels back it, selected by what ``prepare`` is given (the rung
cascade spawns one backend per rung and prepares it on that rung's graph):

* a **CondensedGraph** with compression >= ``FUSED_MIN_COMPRESSION``
  selects K1 (``csrc/condensed.cu``): fixpoint + exactness certificate in
  ONE launch, ``evaluate_certified`` exposed to the cascade so accepted /
  escalated rows never ship event times to the host;
* anything else keeps K2 (``csrc/fifo_eval.cu``), one block per
  configuration, as the raw backstop and for ``evaluate_with_times``.

On CPU tensors (``device="cpu"``) both wrappers run their plain torch
versions; that is how the CPU tests drive this backend.
"""

from __future__ import annotations

from repro_torch.core.backends.base import register_backend
from repro_torch.core.backends.fixpoint import _ScanBackend


@register_backend
class CudaBackend(_ScanBackend):
    """The :mod:`repro_torch.kernels.fifo_eval` kernels (see module
    docstring).  Raw graphs launch one block per configuration, so batch
    padding buys nothing there and bucketing is off; the fused condensed
    path buckets inside the cascade, as in the reference."""

    name = "cuda"
    aliases = ("pallas",)
    use_ref = False
    wants_bucketing = False
