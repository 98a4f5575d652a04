"""The devices of a data-parallel run.

Port of ``instancesegmentation_tpu/parallel/mesh.py``.  A JAX mesh spans
every device of the job from one controller; in torch each process drives
its own devices and the process group joins the processes, so a ``Mesh``
here holds this process's devices, its rank and the world size:

- the data-parallel train step runs one device per process
  (``cuda:<local rank>``); more processes, not more devices, scale it;
- ``ParallelInferenceEngine`` holds one replica per device of its mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from instancesegmentation_tpu_torch.parallel.multihost import process_info


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's devices, its rank and the world size."""

    devices: tuple
    rank: int = 0
    world_size: int = 1

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(num_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (the CPU tests pass ``[cpu] * n``), else over
    every visible CUDA device; the first ``num_devices`` of them when given.

    Raises ``ValueError`` when ``num_devices`` exceeds the devices there are,
    and ``RuntimeError`` when no device is given and CUDA is not available.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices=[torch.device('cpu')] "
                               "to run on the host")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(f"requested {num_devices} devices, only {len(devices)} visible")
        devices = devices[:num_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    rank, world = process_info()
    return Mesh(tuple(devices), rank, world)
