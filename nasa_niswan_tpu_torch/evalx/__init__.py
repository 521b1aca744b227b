"""Evaluation (counterpart of nasa_niswan_tpu/evalx): the metric battery,
the windowed, rollout and closed-loop evaluations, snapshot loading, the
plots and the ``python -m nasa_niswan_tpu_torch.evalx`` CLI."""
