"""The train state: step count, model (parameters and BN running
statistics) and Adam state.

Port of ``instancesegmentation_tpu/train/state.py``.  The JAX package keeps
one immutable pytree that the step returns anew; here the step updates the
model's parameters and BN buffers and the optimizer's moments in place.
The optimizer is ``torch.optim.Adam`` with optax.adam's defaults: b1 0.9,
b2 0.999, eps 1e-8 added outside the square root, no weight decay.

``to_state_tree`` and ``from_state_tree`` carry the whole state to and from
the JAX package's ``TrainState`` tree (what its checkpoints hold): step,
params, batch_stats, and optax's Adam state ``(ScaleByAdamState(count, mu,
nu), EmptyState())``, whose ``mu`` / ``nu`` are Adam's ``exp_avg`` /
``exp_avg_sq`` in the weights' flax layouts and whose ``count`` is every
parameter's ``step``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from instancesegmentation_tpu_torch.models.segment import Segment
from instancesegmentation_tpu_torch.utils.weights import (
    flax_layout,
    jax_variables_to_torch,
    torch_to_flax_tree,
)


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


def to_state_tree(state: TrainState) -> dict:
    """The JAX package's ``TrainState`` tree of ``state`` (what
    ``flax.serialization.to_state_dict`` gives), as numpy arrays:
    ``{"step", "params", "batch_stats", "opt_state": {"0": {"count", "mu",
    "nu"}, "1": {}}}``.  A parameter without Adam state yet (a fresh
    optimizer, or a parameter that never had a gradient) writes zeros, as
    optax's moments are at count 0; ``count`` is the largest Adam step of
    any parameter."""
    layout = flax_layout(state.model)
    variables = torch_to_flax_tree(state.model.state_dict(), layout)
    params = dict(state.model.named_parameters())
    param_layout = {k: v for k, v in layout.items() if k in params}
    moments = {"exp_avg": {}, "exp_avg_sq": {}}
    count = 0
    for name, p in params.items():
        st = state.optimizer.state.get(p, {})
        for m in moments:
            moments[m][name] = st.get(m, torch.zeros_like(p))
        if "step" in st:
            count = max(count, int(st["step"]))
    return {
        "step": np.asarray(state.step, np.int32),
        "params": variables["params"],
        "batch_stats": variables["batch_stats"],
        "opt_state": {
            "0": {"count": np.asarray(count, np.int32),
                  "mu": torch_to_flax_tree(moments["exp_avg"], param_layout)["params"],
                  "nu": torch_to_flax_tree(moments["exp_avg_sq"], param_layout)["params"]},
            "1": {},
        },
    }


def from_state_tree(tree: dict, state: TrainState) -> TrainState:
    """Load the JAX package's ``TrainState`` tree (``to_state_tree``'s
    layout) into ``state`` in place and return it: the model's parameters
    and BN statistics, the step, and Adam's moments and step of every
    parameter.  A tree that does not fit the model raises ``KeyError`` or
    ``ValueError`` before anything is changed."""
    sd = jax_variables_to_torch({"params": tree["params"], "batch_stats": tree["batch_stats"]})
    own = state.model.state_dict()
    sd.update({k: v for k, v in own.items() if k.endswith("num_batches_tracked")})
    adam = tree["opt_state"]["0"]
    mu, nu = (jax_variables_to_torch({"params": adam[m]}) for m in ("mu", "nu"))
    params = dict(state.model.named_parameters())
    if sd.keys() != own.keys() or mu.keys() != params.keys() or nu.keys() != params.keys():
        raise KeyError("the tree's leaves are not the model's")
    for k, v in own.items():
        if sd[k].shape != v.shape or (k in params and not
                                      mu[k].shape == nu[k].shape == v.shape):
            raise ValueError(f"shape mismatch at {k}: {tuple(sd[k].shape)} vs {tuple(v.shape)}")
    state.model.load_state_dict(sd, strict=True)
    state.step = int(np.asarray(tree["step"]))
    count = float(np.asarray(adam["count"]))
    state.optimizer.state.clear()
    for name, p in params.items():
        state.optimizer.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": mu[name].to(device=p.device, dtype=p.dtype),
            "exp_avg_sq": nu[name].to(device=p.device, dtype=p.dtype),
        }
    return state
