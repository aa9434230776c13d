"""Training of the flagship model: losses, the view-step trainer and
checkpoints."""
