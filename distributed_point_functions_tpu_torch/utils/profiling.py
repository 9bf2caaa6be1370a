"""Profiling hooks on `torch.profiler`.

The JAX package wraps `jax.profiler` here; the port's `annotate` is
`torch.profiler.record_function`: a named range inside an active
`torch.profiler.profile` trace, a cheap no-op outside one, so library
code calls it unconditionally:

    with annotate("expand"):
        selections = evaluate_selection_blocks_planes(...)
"""

from __future__ import annotations

import torch


def annotate(name: str):
    """Named sub-region inside an active trace."""
    return torch.profiler.record_function(name)
