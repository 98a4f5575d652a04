"""User tools of the port (``python -m instancesegmentation_tpu_torch.tools.<name>``)."""
