"""Opt-in timing of a wrapper's kernel launches with CUDA events.

A wrapper whose ``events`` attribute is a list records a pair of timing
CUDA events around each of its launches on the current stream and appends
the pair; with ``events`` None nothing is recorded.  ``chip_smoke.py``
reads the pairs after a run to time the kernels on the main path.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def recorded(wrapper):
    """Record the body between two CUDA events when ``wrapper.events`` is a
    list, and append the pair (start, end) to it."""
    events = wrapper.events
    if events is None:
        yield
        return
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    events.append((start, end))
