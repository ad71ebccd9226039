"""The learning smoke (``gapro_tpu_torch/tools/smoke_learn.py``).

On the CPU, the tool's loop for 20 steps at its own sizes, for ISBNet and
SPFormer: every loss finite and the loss falls (the last 4 steps' mean
below the first 4's; the steps alternate the two scenes); the scenes are
then served and scored. The tool's verdict (``all_ap_25%`` above 0.1, the
JAX tool's assertion) decides its exit code. On the card (``gpu``):
ISBNet's first 50 steps, where the loss falls. 300 steps are
``chip_smoke.py``'s learn phase. This file imports no JAX, so the card's
machine runs it:

    python -m pytest --noconftest -m gpu tests/test_torch_smoke_learn.py
"""

import math
import statistics

import pytest
import torch

from gapro_tpu_torch.tools import smoke_learn


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The port's CPU work here on two threads: the test workers share the
    machine's cores, and torch's default of one thread a core each
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("model", ["isbnet", "spformer"])
def test_loss_falls_on_cpu(model):
    res = smoke_learn.run(model, 20, "cpu", log=None)
    losses = res["losses"]
    assert len(losses) == 20 and all(math.isfinite(x) for x in losses)
    assert statistics.mean(losses[-4:]) < statistics.mean(losses[:4])
    assert len(res["instances"]) == 2
    assert {"all_ap", "all_ap_50%", "all_ap_25%"} <= set(res["result"])


@pytest.mark.parametrize("ap25,code", [(0.1, 1), (0.5, 0)])
def test_exit_code_follows_ap25(monkeypatch, ap25, code):
    """AP25 must pass 0.1, as the JAX tool asserts; 0.1 itself fails."""
    monkeypatch.setattr(smoke_learn, "run", lambda *a, **k: dict(
        result={"all_ap": 0.0, "all_ap_50%": 0.0, "all_ap_25%": ap25}))
    assert smoke_learn.main(["--device", "cpu"]) == code


@pytest.mark.gpu
def test_first_50_steps_on_card(cuda_device):
    losses = smoke_learn.run("isbnet", 50, cuda_device, evaluate=False, log=None)["losses"]
    assert all(math.isfinite(x) for x in losses)
    assert statistics.mean(losses[-10:]) < statistics.mean(losses[:10])
