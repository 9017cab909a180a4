"""Serving: the batched engine over the model stack."""
