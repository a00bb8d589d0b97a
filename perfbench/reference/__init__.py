"""The benchmark's plain references of the generator: plain PyTorch that
imports nothing of the program. Each configuration names the module here
that renders it (its ``reference`` key, ``rigid`` without one), and every
such module exposes the same two functions:

- ``check_supported(cfg)`` raises ``ValueError`` for a configuration, given
  as the program's configuration values by name, that the module cannot
  render;
- ``render_rows(seed, indices, cfg, atlas, lowp=False)`` returns the
  outputs of the global sample indices ``indices`` of the stream of
  ``seed``, keyed as the program's outputs; ``lowp`` renders the control.

The shared parts (scenes and streams from the seed, the painter's render,
the photometric jitter, the float arithmetic) are modules of their own,
which a reference imports relatively. The names below are ``rigid``'s, kept
here for the callers that render rigid scenes directly.
"""

from .rigid import SUPPORTED, check_supported, render_rows  # noqa: F401
