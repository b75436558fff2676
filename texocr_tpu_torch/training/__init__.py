"""Training: the loss, the optimizers, the train and eval steps, the host-loader loop and its CLI."""
