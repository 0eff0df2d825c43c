"""Serving steps of the LLM substrate: prefill and decode.  The training
half (optimizer, train/eval steps, data, checkpoints) is ROADMAP P14b."""

from repro_torch.train.steps import make_decode_step, make_prefill_step

__all__ = ["make_decode_step", "make_prefill_step"]
