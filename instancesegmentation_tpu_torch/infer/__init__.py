"""Serving: the instance and whole-image programs, the engine, the
dynamic-batching front end, proposal-based serving and the inference command
(``python -m instancesegmentation_tpu_torch.infer``)."""
