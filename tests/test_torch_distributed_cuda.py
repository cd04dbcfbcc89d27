"""Data parallelism on the card: a cuda-marked test, which skips on a host
without one. No JAX here (the card's machine has none); run there with
``python -m pytest tests/test_torch_distributed_cuda.py -m cuda --noconftest``.

It is chip_smoke.py's phase 9a: two gloo ranks, each a process of its own
on cuda:0, take three f32 train steps (TF32 off, the augmentation in eval
mode) on their halves of a batch, against one rank on the whole batch from
the same state: losses to rel 1e-5, params and batch stats to atol 1e-5,
the replicas bit for bit, and #1 and #2 launched once a step on every rank.
"""

import pytest
import torch

import chip_smoke


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_match_one_rank(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda --noconftest)")
    launches = chip_smoke.dp_step_check(str(tmp_path))
    assert launches["max_pool_3x3_s2"] == launches["max_pool_3x3_s2_backward"] == chip_smoke.DP_WORLD * chip_smoke.DP_STEPS
