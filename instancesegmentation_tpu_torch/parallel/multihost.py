"""Multi-process initialisation and the small host collectives of data
parallelism.

Port of ``instancesegmentation_tpu/parallel/multihost.py`` on
``torch.distributed``.  JAX runs one controller per host over every local
device; torch runs one process per device, joined by a process group:

    from instancesegmentation_tpu_torch.parallel import multihost
    multihost.initialize(coordinator="10.0.0.1:8476",
                         num_processes=2, process_id=0)

With no arguments, ``initialize`` reads torchrun's ``env://`` variables
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), the
counterpart of the TPU pod's auto-detection.  The backend is ``nccl`` on a
machine with CUDA and ``gloo`` without; two ranks that share one card must
pass ``backend="gloo"`` (NCCL refuses two ranks on one device).

Every helper below is the identity in a single process (no group).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

#: torchrun's variables that ``initialize()`` without arguments reads
_ENV_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the default process group (idempotent).

    Pass all three of ``coordinator`` (``host:port`` of rank 0),
    ``num_processes`` and ``process_id``, or none of them to read torchrun's
    environment.  ``backend`` defaults to ``nccl`` when CUDA is available,
    else ``gloo``.  With ``nccl`` the process's current device becomes
    ``cuda:<local_rank()>``.
    """
    if dist.is_initialized():
        return
    # all-or-nothing: a half-specified topology would reach
    # init_process_group as a confusing partial-config failure, and
    # train/config.py's sentinels (0/-1/"" -> None) make one easy to produce
    given = {"--coordinator": coordinator,
             "--num-processes": num_processes,
             "--process-id": process_id}
    missing = [k for k, v in given.items() if v is None]
    if missing and len(missing) != len(given):
        raise ValueError(
            "multihost.initialize needs either no topology flags (torchrun's "
            "environment) or all three; missing: " + ", ".join(missing)
        )
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if missing:
        absent = [v for v in _ENV_VARS if v not in os.environ]
        if absent:
            raise RuntimeError(
                "multihost.initialize without topology flags reads torchrun's "
                "environment, which lacks " + ", ".join(absent)
            )
        rank = int(os.environ["RANK"])
        kwargs = {"init_method": "env://"}
    else:
        rank = int(process_id)
        kwargs = {"init_method": f"tcp://{coordinator}",
                  "world_size": int(num_processes), "rank": rank}
    if backend == "nccl":
        torch.cuda.set_device(_local_rank(rank))
    dist.init_process_group(backend, **kwargs)


def shutdown() -> None:
    """Leave the default process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_info() -> tuple[int, int]:
    """(rank, world size); (0, 1) when no process group exists."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _local_rank(rank: int) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % max(1, torch.cuda.device_count())


def local_rank() -> int:
    """This process's index among the processes of its host: torchrun's
    ``LOCAL_RANK``, else the rank modulo the visible CUDA devices (so ranks
    that share one card all get 0)."""
    return _local_rank(process_info()[0])


def local_batch_slice(global_batch: int) -> slice:
    """The half-open row range of the GLOBAL batch this process feeds.

    Each process's loader materialises only its slice
    (``batch_iterator(local_slice=...)``), so no rows cross processes.
    """
    idx, count = process_info()
    if global_batch % count:
        raise ValueError(
            f"global batch {global_batch} not divisible by {count} processes"
        )
    per = global_batch // count
    return slice(idx * per, (idx + 1) * per)


def host_local_rows(rows, global_batch: int) -> np.ndarray:
    """This process's rows of a global batch of ``global_batch`` rows, as
    numpy (bfloat16 as float32).

    The rows are already local in torch (one process per device); what is
    checked here is the contiguous-block assumption the trainer pairs them
    with: they must be exactly ``local_batch_slice(global_batch)``'s count,
    so that ``rank * per``-style offsets attribute padded-tail rows right.
    """
    if isinstance(rows, torch.Tensor):
        rows = rows.detach()
        rows = (rows.float() if rows.is_floating_point() else rows).cpu().numpy()
    rows = np.asarray(rows)
    expect = local_batch_slice(global_batch)
    if rows.shape[0] != expect.stop - expect.start:
        raise AssertionError(
            f"{rows.shape[0]} local rows, expected the contiguous block "
            f"[{expect.start}, {expect.stop}) of the global batch of {global_batch}"
        )
    return rows


def _comm_device() -> torch.device:
    """Where a tensor for the default group must live: the current CUDA
    device for NCCL, the host for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def sum_across_processes(values) -> np.ndarray:
    """Element-wise sum of a small 1-D float vector over all processes, in
    float64 (identity in one process).  Used for global metric reductions
    (the val-IoU sum and count)."""
    vec = np.asarray(values, np.float64)
    if process_info()[1] == 1:
        return vec
    t = torch.from_numpy(vec.copy()).to(_comm_device())
    dist.all_reduce(t)
    return t.cpu().numpy()


def broadcast_from_main(values) -> np.ndarray:
    """Rank 0's copy of a small 1-D float vector, on every process, in
    float64 (identity in one process).

    The trainer broadcasts its checkpoint observations (exists, best), so
    the restart/adoption/save branches, which gate collective calls, are
    the same on every rank even while the shared file is being written.
    """
    vec = np.asarray(values, np.float64)
    if process_info()[1] == 1:
        return vec
    t = torch.from_numpy(vec.copy()).to(_comm_device())
    dist.broadcast(t, src=0)
    return t.cpu().numpy()


def _state_tensors(state) -> list:
    """Every tensor of a ``TrainState`` that rank 0's copy must overwrite:
    parameters, buffers (BN running statistics and counters) and Adam's
    ``step`` / ``exp_avg`` / ``exp_avg_sq`` of each parameter, created as
    zeros where this rank has none yet (a fresh optimizer)."""
    model, opt = state.model, state.optimizer
    tensors = list(model.parameters()) + list(model.buffers())
    for p in model.parameters():
        st = opt.state[p]
        if not st:
            st.update(step=torch.tensor(0.0), exp_avg=torch.zeros_like(p),
                      exp_avg_sq=torch.zeros_like(p))
        tensors += [st["step"], st["exp_avg"], st["exp_avg_sq"]]
    return tensors


def broadcast_state(state):
    """Rank 0's train state on every rank, in place (identity in one
    process): parameters, BN buffers, Adam's moments and steps, and the
    host step count.  One broadcast per dtype, over flattened copies."""
    if process_info()[1] == 1:
        return state
    dev = _comm_device()
    by_dtype: dict = {}
    for t in _state_tensors(state):
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1).to(dev) for t in ts])
            dist.broadcast(flat, src=0)
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))
    state.step = int(broadcast_from_main([state.step])[0])
    return state
