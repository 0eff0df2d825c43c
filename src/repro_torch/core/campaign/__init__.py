"""Cross-design DSE campaign engine.

Runs many ``(design, optimizer, seed)`` tasks as one scheduled workload:
stepwise optimizers interleaved round-robin, cache-aware routing into
pooled worklist workers or one cross-design hetero-batched fixpoint
dispatch, persistent ``.npz`` checkpoints with deterministic replay
resume, and a result store tracking per-task frontiers and hypervolume.

Attributes resolve lazily (PEP 562) so the numpy-only worker processes
can import ``repro_torch.core.campaign.pool`` without dragging in the
advisor.
"""

import importlib

_ATTRS = {
    "Campaign": "repro_torch.core.campaign.scheduler",
    "CampaignSpec": "repro_torch.core.campaign.scheduler",
    "CampaignTask": "repro_torch.core.campaign.scheduler",
    "DesignContext": "repro_torch.core.campaign.scheduler",
    "QUICK_DESIGNS": "repro_torch.core.campaign.scheduler",
    "TaskSpec": "repro_torch.core.campaign.scheduler",
    "default_workers": "repro_torch.core.campaign.scheduler",
    "RoundRouter": "repro_torch.core.campaign.router",
    "RoutedRequest": "repro_torch.core.campaign.router",
    "WorkerPool": "repro_torch.core.campaign.pool",
    "ResultStore": "repro_torch.core.campaign.store",
    "CheckpointMismatch": "repro_torch.core.campaign.state",
    "load_checkpoint": "repro_torch.core.campaign.state",
    "replay": "repro_torch.core.campaign.state",
    "save_checkpoint": "repro_torch.core.campaign.state",
}


def __getattr__(name):
    module = _ATTRS.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(module), name)


def __dir__():
    return sorted(set(globals()) | set(_ATTRS))


__all__ = [
    "Campaign", "CampaignSpec", "CampaignTask", "CheckpointMismatch",
    "DesignContext", "QUICK_DESIGNS", "ResultStore", "RoundRouter",
    "RoutedRequest", "TaskSpec", "WorkerPool", "default_workers",
    "load_checkpoint", "replay", "save_checkpoint",
]
