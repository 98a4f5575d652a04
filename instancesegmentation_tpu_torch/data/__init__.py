"""Data: the common-format dataset reader, batching and host -> device
prefetch, the preprocessing program of training, and synthetic datasets
and host batches."""
