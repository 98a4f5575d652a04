"""Training: the configuration, the train state (model + Adam) and its
checkpoint tree, the train and eval steps with the preprocessing program in
front of them, ISEG checkpoints (one file, or a directory that keeps the
orbax backend's contract), metrics, and the trainer
(``python -m instancesegmentation_tpu_torch.train``)."""
