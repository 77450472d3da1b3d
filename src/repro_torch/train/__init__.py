"""Training: optimizer, gradient compression, train step, checkpoints."""
