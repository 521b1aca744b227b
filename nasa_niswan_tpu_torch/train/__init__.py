"""Training (counterpart of nasa_niswan_tpu/train): the epoch driver and its
steps, checkpoints, the run configuration and the CLI
(``python -m nasa_niswan_tpu_torch.train``)."""
