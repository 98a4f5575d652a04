"""Data parallelism over ``torch.distributed``: process groups, the
data-parallel train and eval steps with synchronised BatchNorm, and the
replicated inference engine.

Port of ``instancesegmentation_tpu/parallel``.  JAX drives every device of a
mesh from one controller; here one process drives each training device
(``multihost.initialize``, or torchrun), and the inference engine holds one
replica of the serving program per device of this process.
"""

from instancesegmentation_tpu_torch.parallel import multihost
from instancesegmentation_tpu_torch.parallel.mesh import Mesh, make_mesh
from instancesegmentation_tpu_torch.parallel.data_parallel import make_parallel_steps
from instancesegmentation_tpu_torch.parallel.inference import ParallelInferenceEngine
