"""Data: the preprocessing program of training and the synthetic host
batch."""
