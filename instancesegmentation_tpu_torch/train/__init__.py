"""Training: the configuration, the train state (model + Adam) and the
train and eval steps with the preprocessing program in front of them."""
