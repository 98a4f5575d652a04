"""Dataset converters: COCO / OCHuman / Supervisely -> common format, the
port's copy of ``instancesegmentation_tpu/data/converters/``.

Offline ETL: run once per source dataset; training only ever reads the
converted output.  Images and masks go through the port's own codecs
(``core/imread.py``, ``core/imwrite.py``) and rasterizer
(``core/rasterize.py``), so nothing here needs cv2.

    python -m instancesegmentation_tpu_torch.data.converters.coco IMG_DIR ANN.json OUT
    python -m instancesegmentation_tpu_torch.data.converters.ochuman ANN.json IMG_DIR OUT
    python -m instancesegmentation_tpu_torch.data.converters.supervisely PROJECT_DIR OUT
"""

from instancesegmentation_tpu_torch.data.converters.coco import transfer_coco
from instancesegmentation_tpu_torch.data.converters.migrate import migrate_class_keys
from instancesegmentation_tpu_torch.data.converters.ochuman import transfer_ochuman
from instancesegmentation_tpu_torch.data.converters.supervisely import (
    transfer_supervisely_to_common,
)
