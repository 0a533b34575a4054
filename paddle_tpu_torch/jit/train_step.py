"""Train step (counterpart of paddle_tpu/jit/train_step.py:TrainStep).

The reference compiles forward, backward and the update into one XLA
program; PyTorch runs them eagerly, one call after the other.
"""
from __future__ import annotations

from typing import Callable

import torch


class TrainStep:
    """step = TrainStep(model, optimizer, loss_fn); loss = step(*batch).

    loss_fn(model, *batch) -> scalar loss tensor. Batch elements may be
    tensors or arrays; they are moved to the model's device. Each call runs
    forward, backward and the optimizer update, zeroes the grads and
    returns the detached loss."""

    def __init__(self, model, optimizer, loss_fn: Callable):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.device = next(model.parameters()).device

    def __call__(self, *batch):
        batch = [torch.as_tensor(x, device=self.device) for x in batch]
        loss = self.loss_fn(self.model, *batch)
        loss.backward()
        self.optimizer.step()
        self.optimizer.zero_grad()
        return loss.detach()
