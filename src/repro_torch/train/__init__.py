"""Training/serving substrate: optimizer, steps, data, checkpointing."""

from repro_torch.train.optimizer import OptConfig, adamw_update, init_opt_state
from repro_torch.train.steps import (init_train_state, loss_fn,
                                     make_decode_step, make_eval_step,
                                     make_prefill_step, make_train_step)

__all__ = [
    "OptConfig", "adamw_update", "init_opt_state", "init_train_state",
    "loss_fn", "make_decode_step", "make_eval_step", "make_prefill_step",
    "make_train_step",
]
