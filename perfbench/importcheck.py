"""The check that a run loaded nothing of JAX: neither ``jax``, ``jaxlib``
nor ``flax``, nor the JAX package ``flowgen``. A module is judged by its
top-level name (the part before the first dot), compared whole:
``flowgen_torch`` is the program and passes, ``flowgen.ops`` does not."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "flowgen"})


def forbidden(names: Iterable[str]) -> List[str]:
    """The names among ``names`` whose top-level name is forbidden."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def loaded() -> List[str]:
    """The forbidden modules this process has loaded."""
    return forbidden(list(sys.modules))
