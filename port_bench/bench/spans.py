"""Spans around calls into the program's layers, from the benchmark's side.

A span wraps a module's forward (pre- and post-hooks), a method of one
object, or a function of a module, without editing the program. On a CUDA
device each call records a pair of CUDA events (the device time between
them is the span's) and opens a ``torch.profiler.record_function`` range
named ``pb:<span>``, which the trace reduction reads. Nothing is read back
until :meth:`Spans.totals`, after the window.
"""
from __future__ import annotations

import functools
from collections import defaultdict
from typing import Callable, Dict, List

import torch

PREFIX = "pb:"


class Spans:
    def __init__(self, device: torch.device, enabled: bool = True):
        self.cuda = torch.device(device).type == "cuda"
        self.enabled = enabled
        self.record_shapes = False  # the work counters' shapes, while the profiler records
        self.events: Dict[str, List] = defaultdict(list)
        self.calls: Dict[str, int] = defaultdict(int)
        self.shapes: Dict[str, List] = defaultdict(list)
        self._open: Dict[str, List] = defaultdict(list)
        self._handles = []
        self._undo: List[Callable[[], None]] = []

    # -- opening and closing one call ------------------------------------
    def begin(self, name: str) -> None:
        if not self.enabled:
            return
        rf = torch.profiler.record_function(PREFIX + name)
        rf.__enter__()
        ev = None
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        self._open[name].append((rf, ev))

    def end(self, name: str) -> None:
        if not self.enabled or not self._open[name]:
            return
        rf, ev = self._open[name].pop()
        if ev is not None:
            stop = torch.cuda.Event(enable_timing=True)
            stop.record()
            self.events[name].append((ev, stop))
        self.calls[name] += 1
        rf.__exit__(None, None, None)

    # -- where spans go ---------------------------------------------------
    def module(self, name: str, mod: torch.nn.Module, shapes: Callable = None) -> None:
        """A span around every call of ``mod``'s forward; ``shapes(args)``,
        when given, records what the work counters need of each call."""
        def pre(_m, args):
            if shapes is not None and self.enabled and self.record_shapes:
                self.shapes[name].append(shapes(args))
            self.begin(name)

        self._handles.append(mod.register_forward_pre_hook(pre))
        self._handles.append(mod.register_forward_hook(lambda _m, _a, _o: self.end(name)))

    def method(self, name: str, obj, attr: str) -> None:
        self._wrap(name, obj, attr, instance=True)

    def function(self, name: str, module, attr: str, shapes: Callable = None) -> None:
        self._wrap(name, module, attr, instance=False, shapes=shapes)

    def _wrap(self, name, owner, attr, instance, shapes=None):
        # an instance's own attribute (another wrapper) is restored, not deleted
        orig = getattr(owner, attr)

        @functools.wraps(orig)
        def wrapped(*args, **kwargs):
            if shapes is not None and self.enabled and self.record_shapes:
                self.shapes[name].append(shapes(*args, **kwargs))
            self.begin(name)
            try:
                return orig(*args, **kwargs)
            finally:
                self.end(name)

        had = attr in vars(owner)
        setattr(owner, attr, wrapped)
        if instance and not had:
            self._undo.append(lambda: delattr(owner, attr))
        else:
            self._undo.append(lambda: setattr(owner, attr, orig))

    def on_remove(self, undo: Callable[[], None]) -> None:
        self._undo.append(undo)

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        for undo in reversed(self._undo):
            undo()
        self._handles, self._undo = [], []

    # -- readings ----------------------------------------------------------
    def totals(self) -> Dict[str, Dict[str, float]]:
        """{span: {"calls", "device_ms"}} (device_ms only on CUDA);
        synchronizes once."""
        if self.cuda:
            torch.cuda.synchronize()
        out = {}
        for name, n in self.calls.items():
            out[name] = {"calls": n}
            if self.cuda:
                out[name]["device_ms"] = sum(a.elapsed_time(b) for a, b in self.events[name])
        return out
