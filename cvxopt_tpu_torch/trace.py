"""Spans of the port's layers, for the trace of a torch.profiler session.

    with trace.span("cvx.ipm.pass"):
        ...

A span is named ``cvx.<layer>.<what>``, with <layer> one of frontend,
cascade, ipm, cone and kkt; a ``cvx.<layer>.sync`` span wraps one host
read of a device value.  The cone layer's two, ``cvx.cone.scaling``
(the NT scaling's computation and update) and ``cvx.cone.step`` (the
steps to the cones' boundary), open in coneqp's IPM loop on dims with
a 'q' or 's' part only.  While a `torch.profiler` session records, a
span is a ``torch.profiler.record_function`` range: it lands on the
profiler's timeline beside the kernels it launches, and the profiler's
chrome trace exports it.  Spans of one solver call nest under its root span
(``cvx.frontend.*`` or ``cvx.cascade.solve``) on the calling thread.
With no session recording, a span is one flag read and a shared no-op
context; there is no switch besides the profiler itself.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()

if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def recording() -> bool:
        """Whether a torch.profiler session is recording."""
        return _autograd_profiler._is_profiler_enabled
else:                      # a torch without the flag: spans always on
    def recording() -> bool:
        return True


def span(name: str):
    """A context manager: a profiler range named `name` while a session
    records, a no-op otherwise."""
    if recording():
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap
