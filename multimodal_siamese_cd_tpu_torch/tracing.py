"""Host spans inside the port: where the feed, the training step and
serving spend their host time.

``span(name, id=None)`` times one stretch of host work::

    with tracing.span("serve.pad"):
        ...

Tracing is off by default, and then a span is one shared no-op context:
no clock reading, no profiler annotation, nothing recorded. It is on after
:func:`enable`, and while a ``torch.profiler`` is active in the thread that
calls into the program: the training window, the feed's pull and
``ServingModel.predict`` each set the module's flag from the calling
thread's profiler (:func:`follow_profiler`), so the program's own threads
(the staging thread, the loader's workers) record while it runs.

When on, each span appends ``(name, id, parent, thread, t0, t1)`` to a
ring that keeps the newest :data:`RING` records (:func:`records`): ``t0``
and ``t1`` are ``time.perf_counter()`` seconds, ``parent`` is the name of
the enclosing span of the same thread, ``thread`` the thread's name, and
``id`` ties the spans of one request or window together (a span given no
``id`` takes its parent's). Where the profiler is active in the calling
thread, the span is also a ``torch.profiler.record_function`` of its name,
so it lies on the trace's timeline beside the device's work (a
``record_function`` in another thread would not reach the trace).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch

RING = 1 << 17

_records: collections.deque = collections.deque(maxlen=RING)
_local = threading.local()
_enabled = False   # enable() / disable()
_on = False        # _enabled, or a profiler active in the last caller
_OFF = contextlib.nullcontext()   # every span while tracing is off


class _Span:
    __slots__ = ("name", "id", "parent", "stack", "annotation", "t0")

    def __init__(self, name: str, id):
        self.name, self.id = name, id

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        outer = stack[-1] if stack else None
        self.parent = None if outer is None else outer.name
        if self.id is None and outer is not None:
            self.id = outer.id
        stack.append(self)
        self.stack = stack
        self.annotation = None
        # the annotation's own cost lies inside the span, not between spans
        self.t0 = time.perf_counter()
        if torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        t1 = time.perf_counter()
        self.stack.pop()
        _records.append((self.name, self.id, self.parent,
                         threading.current_thread().name, self.t0, t1))
        return False


def span(name: str, id=None):
    """A context that records ``name`` while tracing is on (see the
    module's docstring)."""
    if not _on:
        return _OFF
    return _Span(name, id)


def follow_profiler() -> None:
    """Turn tracing on while a profiler is active in the calling thread (or
    :func:`enable` holds it on), off otherwise; the program's entry points
    call it."""
    global _on
    _on = _enabled or torch.autograd._profiler_enabled()


def enable() -> None:
    global _enabled, _on
    _enabled = _on = True


def disable() -> None:
    """Stop recording (a profiler active at the next entry turns it back
    on)."""
    global _enabled, _on
    _enabled = _on = False


def records() -> list:
    """The spans' ring, oldest first."""
    while True:
        try:
            return list(_records)
        except RuntimeError:   # another thread appended meanwhile
            continue


def clear() -> None:
    _records.clear()
