"""Host utilities of the port."""

from instancesegmentation_tpu_torch.core.device import pick_device
