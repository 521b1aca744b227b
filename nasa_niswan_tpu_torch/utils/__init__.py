"""Run utilities (counterpart of nasa_niswan_tpu/utils/): the run log
(logging.py), seeding (seeding.py) and tracing and timing (profiling.py).
The JAX package's ``utils/cache.py`` (XLA's persistent compilation cache)
has no counterpart: the port compiles its kernels once per checkout
(ops/_build.py)."""

from nasa_niswan_tpu_torch.utils.logging import LoggerDecorator, run_logger
from nasa_niswan_tpu_torch.utils.seeding import seed_rng
