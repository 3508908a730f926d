"""Training: optimizers, int8 gradient compression and the train step."""
