"""The port's entry points (perseus_tpu_torch/graft_entry.py) against the
root __graft_entry__.py, on the CPU.

  * ``entry``: the same example batch (NCHW, bit for bit), and the folded
    bf16 forward of the same JAX weights to 0.05 (tests/test_torch_resnet.py's
    bf16 tolerance: both frameworks round every conv output to bf16 after
    f32 sums taken in another order); its default weights give a finite
    (8, 16) output;
  * ``dryrun_multichip(2, device="cpu")``: two gloo ranks run the train step
    and the device-resident epoch and print both lines, with finite losses.
"""

import math
import re

import jax
import numpy as np
import pytest
import torch

from perseus_tpu.models import resnet as jr
from perseus_tpu_torch import graft_entry
from perseus_tpu_torch.models import convert

BF16_ATOL = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several test
    processes side by side on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_entry_matches_the_jax_entry():
    import __graft_entry__ as ge

    with jax.enable_x64(False):  # the JAX entry as it runs outside the tests: f32 draws
        fn_j, (example_j,) = ge.entry()
        out_j = np.asarray(jax.jit(fn_j)(example_j))
        # the entry's weights (its own eager init: the op cache is warm)
        params, stats = jr.init_keypoint_cnn(jax.random.key(0), n_keypoints=8, num_channels=4)
    fn_t, (example_t,) = graft_entry.entry(device="cpu", state_dict=convert.from_jax_params(params, stats))
    assert example_t.shape == (8, 4, 256, 256) and example_t.dtype == torch.float32
    np.testing.assert_array_equal(example_t.permute(0, 2, 3, 1).numpy(), np.asarray(example_j))
    out_t = fn_t(example_t)
    assert out_t.shape == out_j.shape == (8, 16) and out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), out_j, atol=BF16_ATOL)

    fn_d, (example_d,) = graft_entry.entry(device="cpu")  # the default: KeypointCNN's seed-0 init
    out_d = fn_d(example_d)
    assert out_d.shape == (8, 16) and torch.isfinite(out_d).all()


def test_dryrun_multichip_on_two_cpu_ranks(capsys):
    result = graft_entry.dryrun_multichip(2, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    step = [ln for ln in lines if re.fullmatch(r"dryrun_multichip\(2\): ok, loss=\S+", ln)]
    epoch = [ln for ln in lines if ln.startswith("dryrun_multichip(2): device-data epoch ok, losses=[")]
    assert len(step) == 1 and len(epoch) == 1, lines
    assert math.isfinite(result["loss"]) and result["loss"] > 0
    assert len(result["losses"]) == 2 and all(math.isfinite(v) for v in result["losses"])
    assert float(step[0].split("loss=")[1]) == pytest.approx(result["loss"], abs=1e-5)
