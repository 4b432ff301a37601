"""Operators of the port. Only ``loss.nll_from_logits`` so far (the
transformer's loss); the registered ops wait for the Program/Executor
slices."""
