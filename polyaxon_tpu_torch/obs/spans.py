"""Named phases of the training step as ``torch.profiler`` ranges.

``span(name)`` is a ``record_function`` range while a profiler records on
this thread, so the range lands in the one trace the profiler exports
(``outputs/profile/trace.json`` under the runtime's ``profile:`` key), on
the clock of the device's kernels. Otherwise it is one shared no-op
context: no ``RecordFunction`` is made and nothing is kept.
"""

from __future__ import annotations

import contextlib

import torch

OFF = contextlib.nullcontext()


def span(name: str):
    """A ``with`` context naming the work inside it ``name`` in the
    profiler's trace."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return OFF
