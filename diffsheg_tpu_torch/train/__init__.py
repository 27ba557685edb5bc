"""Training: the step, the trainer loop, checkpoints."""
