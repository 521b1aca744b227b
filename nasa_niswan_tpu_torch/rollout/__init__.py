from nasa_niswan_tpu_torch.rollout.autoregressive import (
    make_rollout_fn,
    make_streaming_rollout,
    model_days_per_min,
)
