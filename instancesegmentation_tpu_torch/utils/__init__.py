"""Weight carrying between the flax layout and the port's state dict;
profiling (``torch.profiler`` traces, step timing) and debug helpers."""
