"""Weight carrying between the flax layout and the port's state dict."""
