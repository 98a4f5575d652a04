"""Serving: the instance and whole-image programs, the engine and the
dynamic-batching front end."""
