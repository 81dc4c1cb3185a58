"""Training: the optimizer, the train state and the differentiable step."""
