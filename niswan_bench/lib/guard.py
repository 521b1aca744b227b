"""The import guard: a run fails if its process holds JAX or the JAX package.

Module names are compared by their top-level name (the part before the
first dot), whole: ``nasa_niswan_tpu_torch`` is another name than
``nasa_niswan_tpu`` and passes.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "nasa_niswan_tpu")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    """The top-level names among ``names`` (default: ``sys.modules``) that
    are forbidden, sorted."""
    names = list(sys.modules) if names is None else names
    return sorted({top_level(n) for n in names} & set(FORBIDDEN))


class ForbiddenImport(RuntimeError):
    pass


def check(stage: str) -> None:
    """Raise ``ForbiddenImport`` naming what was found at ``stage``."""
    found = forbidden_loaded()
    if found:
        raise ForbiddenImport(f"forbidden modules loaded {stage}: {', '.join(found)}")
