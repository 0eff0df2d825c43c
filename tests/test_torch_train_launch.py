"""The port's train CLI (``repro_torch.launch.train``) on the CPU.

* kill-and-resume, as the reference's ``test_train_resume_end_to_end``:
  a second start resumes with nothing left to do, and a 3-then-6 split
  run ends within 5e-3 of the straight-through run's last loss;
* the checkpoint it writes restores in the reference;
* MiniCPM trains on the WSD schedule, every other arch on cosine, the
  logged learning rates are those schedules', and MiniCPM's loss falls
  over 40 steps (``examples/train_lm.py`` asserts it of the reference);
* a frontend arch (its ``embeds`` prefix) trains, and without
  ``--device cpu`` the CLI needs the card.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.train import checkpoint as ref_ck
from repro.train.steps import init_train_state as ref_init_train_state

from repro_torch.launch.train import main
from repro_torch.train.optimizer import OptConfig, schedule_lr


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _args(ckpt, steps, *extra):
    return ["--arch", "qwen2-1.5b", "--steps", str(steps), "--batch", "2",
            "--seq", "32", "--ckpt", str(ckpt), "--save-every", "3",
            "--log-every", "100", "--device", "cpu", *extra]


def test_train_resume_end_to_end(tmp_path):
    """Kill-and-resume: losses after resume continue from the checkpoint
    (deterministic data => the resumed run matches an uninterrupted one)."""
    out1 = main(_args(tmp_path, 6))        # runs 0..5, saves at 3 and 6
    assert out1["steps"] == 6
    # second invocation: nothing left to do (resumes at 6)
    out2 = main(_args(tmp_path, 6))
    assert out2 == {"first_loss": None, "last_loss": None, "steps": 0}
    # fresh run to step 3 then resumed to 6 matches a straight-through run
    out3 = main(_args(tmp_path / "b", 3))
    out4 = main(_args(tmp_path / "b", 6))
    assert out3["steps"] == 3 and out4["steps"] == 3
    assert abs(out4["last_loss"] - out1["last_loss"]) < 5e-3
    # the checkpoint is the reference's format: it restores there
    rcfg = REF_ARCHS["qwen2-1.5b"].reduced()
    params, opt = ref_init_train_state(rcfg, jax.random.PRNGKey(0))
    target = {"params": params, "opt": opt}
    got = ref_ck.restore(str(tmp_path), 6, target)
    assert int(got["opt"]["step"]) == 6
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(target)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert np.isfinite(np.asarray(got["params"]["embed"]["tok"])).all()
    assert not jnp.array_equal(got["params"]["embed"]["tok"],
                               params["embed"]["tok"])


def _logged_lrs(text):
    return [float(x) for x in re.findall(r" lr ([0-9.e+-]+) ", text)]


def test_minicpm_trains_on_wsd_and_its_loss_falls(capsys):
    steps = 40
    out = main(["--arch", "minicpm-2b", "--steps", str(steps), "--batch",
                "4", "--seq", "64", "--log-every", "1", "--lr", "3e-3",
                "--device", "cpu"])
    lrs = _logged_lrs(capsys.readouterr().out)
    assert len(lrs) == steps
    opt = OptConfig(lr=3e-3, schedule="wsd", warmup_steps=10,
                    total_steps=steps)
    want = [float(schedule_lr(opt, torch.tensor(s + 1))) for s in
            range(steps)]
    np.testing.assert_allclose(lrs, want, rtol=1e-2)
    # WSD holds the peak between warmup and the decay window
    assert lrs[10] == lrs[30] == pytest.approx(3e-3, rel=1e-2)
    assert out["last_loss"] < out["first_loss"]


def test_frontend_arch_trains_on_cosine(capsys):
    out = main(["--arch", "internvl2-2b", "--steps", "4", "--batch", "2",
                "--seq", "16", "--log-every", "1", "--device", "cpu"])
    lrs = _logged_lrs(capsys.readouterr().out)
    opt = OptConfig(lr=1e-3, schedule="cosine", warmup_steps=10,
                    total_steps=4)
    want = [float(schedule_lr(opt, torch.tensor(s + 1))) for s in range(4)]
    np.testing.assert_allclose(lrs, want, rtol=1e-2)
    assert out["steps"] == 4 and np.isfinite(out["last_loss"])


def test_the_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--steps", "1", "--batch", "1", "--seq", "8"])
