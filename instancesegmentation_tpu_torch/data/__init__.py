"""Data: the common-format dataset reader, batching in threads or worker
processes and host -> device prefetch, the preprocessing program of
training, synthetic datasets and host batches, and the dataset converters
(``data/converters/``: COCO, OCHuman, Supervisely -> common format)."""
