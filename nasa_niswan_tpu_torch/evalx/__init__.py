"""Evaluation metrics (counterpart of nasa_niswan_tpu/evalx; the training
step's R^2 only so far)."""
