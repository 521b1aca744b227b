"""Evaluation (counterpart of nasa_niswan_tpu/evalx; the training step's
R^2 and the closed-loop evaluation of a seq2seq snapshot so far)."""
