"""Host utilities of the port: device selection, the common format's keys
and records, boxes, masks, the image reader (``imread``) with the PNG codec
and EXIF orientation, rasterisation and drawing."""

from instancesegmentation_tpu_torch.core.device import pick_device
