"""The port's LLM decode demo (``repro_torch.launch.decode_demo``): the
reference's flow and return dict, on the CPU when asked, for every
reduced arch."""

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_decode_demo_smoke():
    from repro_torch.launch.decode_demo import main

    out = main(["--arch", "qwen2-1.5b", "--batch", "1",
                "--prompt-len", "8", "--gen", "3", "--device", "cpu"])
    assert set(out) == {"prefill_s", "decode_s", "tok_per_s", "tokens"}
    tokens = np.asarray(out["tokens"])
    assert tokens.shape == (1, 3)
    assert out["prefill_s"] > 0 and out["decode_s"] > 0


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_demo_every_arch_is_seeded(arch):
    """Batch 4 on each reduced arch: token ids inside the padded vocab,
    and the same seed gives the same tokens."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.decode_demo import main

    argv = ["--arch", arch, "--batch", "4", "--prompt-len", "16",
            "--gen", "4", "--device", "cpu", "--seed", "3"]
    a, b = main(argv), main(argv)
    vpad = -(-get_arch(arch).reduced().vocab // 16) * 16
    assert a["tokens"].shape == (4, 4)
    assert ((a["tokens"] >= 0) & (a["tokens"] < vpad)).all()
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
