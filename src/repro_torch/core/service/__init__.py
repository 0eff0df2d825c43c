"""Async FIFO-sizing advisory service with cross-session hetero batching.

The service layer turns the repo from a batch tool into a server: a
:class:`DesignRegistry` traces each design once and advises on it
forever; each client :class:`Session` is a stepwise optimizer driven by
the ``propose()/observe()`` protocol; the
:class:`CrossSessionBatcher` packs outstanding evaluation requests from
*different* clients and *different* designs into single routed
dispatches (sharing :class:`~repro_torch.core.campaign.router.RoundRouter`
with the campaign engine); and :class:`AdvisorClient` /
``python -m repro_torch.launch.serve`` expose it in-process and over
JSON-lines TCP/stdio (the reference's wire protocol v2, unchanged).
Everything runs on the registry's torch device: the card unless the
caller passes ``device="cpu"``.

Everything here is exact: a session's frontier is bit-identical to a
solo ``FifoAdvisor.run()`` with the same seed, regardless of batching.
"""

from repro_torch.core.config import EvalConfig
from repro_torch.core.faults import Fault, FaultPlan, InjectedFault
from repro_torch.core.service.batcher import (AdvisoryService,
                                              CrossSessionBatcher,
                                              ServiceOverloaded)
from repro_torch.core.service.protocol import (ERROR_CODES, PROTO,
                                               AdvisorClient,
                                               ProtocolError,
                                               ProtocolHandler,
                                               SessionHandle, adapt_v1,
                                               decode_line, encode_line)
from repro_torch.core.service.registry import DesignRegistry
from repro_torch.core.service.session import Session
from repro_torch.core.service.snapshot import (SnapshotError,
                                               load_snapshot,
                                               save_snapshot)

__all__ = [
    "AdvisorClient", "AdvisoryService", "CrossSessionBatcher",
    "DesignRegistry", "ERROR_CODES", "EvalConfig", "Fault", "FaultPlan",
    "InjectedFault", "PROTO", "ProtocolError", "ProtocolHandler",
    "ServiceOverloaded", "Session", "SessionHandle", "SnapshotError",
    "adapt_v1", "decode_line", "encode_line", "load_snapshot",
    "save_snapshot",
]
