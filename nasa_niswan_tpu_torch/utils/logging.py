"""Run logging (counterpart of nasa_niswan_tpu/utils/logging.py; reference
utils.py:90-119 LoggerDecorator).

Wraps an entry point with file logging and wall-clock timing: the run's
configuration and elapsed time go to ``logger.log`` in the snapshot
directory, in the JAX package's format (``LEVEL date time message``).
"""

from __future__ import annotations

import datetime
import functools
import logging
import time

LOGGER = "nasa_niswan_tpu_torch"


class LoggerDecorator:
    def __init__(self, log_file: str, level: int = logging.INFO):
        self.log_file = log_file
        self.level = level

    def __call__(self, func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            logger = logging.getLogger(LOGGER)
            logger.setLevel(self.level)
            handler = logging.FileHandler(self.log_file)
            handler.setFormatter(logging.Formatter("%(levelname)s %(asctime)s %(message)s"))
            logger.addHandler(handler)
            tic = time.time()
            try:
                return func(*args, **kwargs)
            finally:
                elapsed = str(datetime.timedelta(seconds=time.time() - tic))
                logger.info(f"Run configuration: {args, kwargs}, Elapsed time: {elapsed}")
                logger.removeHandler(handler)
                handler.close()

        return wrapper


def run_logger(name: str = LOGGER) -> logging.Logger:
    return logging.getLogger(name)
