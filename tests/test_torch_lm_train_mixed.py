"""The MoE, hybrid, vision, xLSTM and encoder-decoder smoke twins
through the port's training path against the reference's (the checks
of ``test_torch_lm_train.py``: loss, gradients, remat, chunked loss,
the products ``dots`` remat keeps, train steps with and without
accumulation, eval, the bf16 loss)."""

import pytest
import torch

from test_torch_lm_archs_mixed import MIXED
from test_torch_lm_train import (check_bf16_first_step,
                                 check_dots_keep_like_reference,
                                 check_loss_and_grads, check_train_steps)

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", MIXED)
def test_twin_loss_and_grads_like_reference(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", MIXED)
def test_twin_dots_remat_keeps_like_reference(arch, monkeypatch):
    check_dots_keep_like_reference(arch, monkeypatch)


@pytest.mark.parametrize("arch", MIXED)
def test_twin_train_steps_like_reference(arch):
    check_train_steps(arch)


@pytest.mark.parametrize("arch", MIXED)
def test_twin_bf16_first_step_like_reference(arch):
    check_bf16_first_step(arch)
