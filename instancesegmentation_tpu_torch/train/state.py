"""The train state: step count, model (parameters and BN running
statistics) and Adam state.

Port of ``instancesegmentation_tpu/train/state.py``.  The JAX package keeps
one immutable pytree that the step returns anew; here the step updates the
model's parameters and BN buffers and the optimizer's moments in place.
The optimizer is ``torch.optim.Adam`` with optax.adam's defaults: b1 0.9,
b2 0.999, eps 1e-8 added outside the square root, no weight decay.
"""
from __future__ import annotations

import dataclasses

import torch

from instancesegmentation_tpu_torch.models.segment import Segment


def adam(params, learning_rate: float) -> torch.optim.Adam:
    """optax.adam(learning_rate) for torch parameters."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.0)


@dataclasses.dataclass
class TrainState:
    """Everything the train step mutates."""

    step: int
    model: Segment
    optimizer: torch.optim.Adam

    @classmethod
    def create(cls, model: Segment, learning_rate: float) -> "TrainState":
        return cls(step=0, model=model, optimizer=adam(model.parameters(), learning_rate))

    @property
    def variables(self) -> dict:
        """The model's state dict: parameters and BN running statistics."""
        return self.model.state_dict()
