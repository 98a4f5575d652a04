"""Host utilities of the port: device selection, the common format's keys
and records, boxes, masks, the PNG codec, rasterisation and drawing."""

from instancesegmentation_tpu_torch.core.device import pick_device
