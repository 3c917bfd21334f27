"""The program's tracer: spans and counters where the work happens.

Off by default: :func:`enable` switches it on for the process, :func:`disable`
off, :func:`reset` drops what it holds. While it is off, :func:`span` and
:func:`count` return after one check of a module-level flag: no clock read,
no profiler range, nothing on the device, no synchronization. (A span given
a ``timings`` dict reads the clock either way, as the eval loops' seconds
are kept whether the tracer is on or not.)

While it is on:

- ``span(name)`` keeps a record in memory: the name, the thread, start and
  end on ``time.perf_counter_ns()``, the span open around it on the same
  thread (its parent) and, where the call site knows it, the video. It also
  opens ``torch.profiler.record_function("dvis:<name>")``, so that a
  profiler recording at the same time puts the span on the timeline of the
  kernels it launched and of the device's idle gaps around it.
- ``count(name, n)`` adds ``n`` to an integer counter.

Nothing is written while the program runs: :func:`totals`, :func:`counters`
and :func:`records` read what was kept (``python -m dvis_plus_tpu_torch.cli
--eval-only --trace-out <file>`` writes them at the end of an evaluation).

Spans and counters (where, and what they time or count):

- ``data.decode`` / ``data.normalize`` / ``data.frames``: the eval mapper
  (``data/mapper.py``): the JPEG reads; the resize into the zeroed uint8
  canvas; the frames mapped.
- ``eval.frames_on_card``: the frames of the eval mapper's uint8 canvas that
  ``engine/inference.py::_frames`` normalized on the model's device (a
  padded window's repeats of its last frame not counted); 0 where float32
  frames are handed in.
- ``eval.forward`` (``timings["model_s"]``): a video's forward in the eval
  loops, synchronized.
- ``eval.page_out`` / ``eval.page_in`` and ``eval.page_out_bytes`` /
  ``eval.page_in_bytes``: host paging of the tensors beyond the eval memory
  budget (``engine/inference.py``): to the host, and back to the device.
- ``eval.post`` (``post_s``), ``eval.class_map``, ``eval.download``
  (``download_s``), ``eval.segments`` (``segments_s``), ``eval.evaluator``
  (``png_s`` in the VPS and VSS loops, ``rows_s`` in the VIS and DAQ loops):
  the eval loops' post-processing and its parts.
- ``assignment.auction`` with ``assignment.auction_calls``,
  ``assignment.auction_rounds``, ``assignment.auction_checks`` (one host
  synchronization each) and ``assignment.auction_capped``
  (``ops/assignment.py``).
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

import torch

PREFIX = "dvis:"  # the profiler range of span ``x`` is ``dvis:x``

_on = False
_clock = time.perf_counter_ns
_records: list = []  # list.append is atomic: threads append without a lock
_counters: Dict[str, int] = {}
_counter_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()  # each thread's stack of open span ids
_NULL = contextlib.nullcontext()


class Record(NamedTuple):
    name: str
    thread: int  # threading.get_ident()
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]  # the id of the span open around it on its thread
    video: object


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Drop every record and counter."""
    global _ids
    _records.clear()
    with _counter_lock:
        _counters.clear()
    _ids = itertools.count(1)


class _Span:
    __slots__ = ("name", "video", "timings", "key", "traced", "t0", "id", "parent", "rf")

    def __init__(self, name, video, timings, key, traced):
        self.name, self.video, self.timings, self.key, self.traced = name, video, timings, key, traced

    def __enter__(self):
        if self.traced:
            stack = _local.__dict__.setdefault("stack", [])
            self.parent = stack[-1] if stack else None
            self.id = next(_ids)
            stack.append(self.id)
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.t0 = _clock()  # the profiler range's own cost stays outside
        return self

    def __exit__(self, *exc):
        t1 = _clock()
        if self.timings is not None:
            self.timings[self.key] = self.timings.get(self.key, 0.0) + (t1 - self.t0) * 1e-9
        if self.traced:
            self.rf.__exit__(None, None, None)
            _local.stack.pop()
            _records.append(Record(self.name, threading.get_ident(), self.t0, t1, self.id,
                                   self.parent, self.video))
        return False


def span(name: str, video=None, timings: Optional[dict] = None, key: Optional[str] = None):
    """A context manager around the work of span ``name``. ``timings[key]``,
    when a dict is given, accumulates the span's seconds whether the tracer
    is on or not."""
    if not _on and timings is None:
        return _NULL
    return _Span(name, video, timings, key, _on)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (a host integer: nothing is read back)."""
    if not _on:
        return
    with _counter_lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    with _counter_lock:
        return dict(_counters)


def records() -> List[Record]:
    return list(_records)


def totals() -> Dict[str, Dict[str, float]]:
    """{span: {"calls", "host_s", "self_s"}}: the calls, their seconds, and
    their seconds less what their child spans cover."""
    recs = records()
    covered = defaultdict(int)
    for r in recs:
        if r.parent is not None:
            covered[r.parent] += r.end_ns - r.start_ns
    out: Dict[str, Dict[str, float]] = {}
    for r in recs:
        t = out.setdefault(r.name, {"calls": 0, "host_s": 0.0, "self_s": 0.0})
        d = r.end_ns - r.start_ns
        t["calls"] += 1
        t["host_s"] += d * 1e-9
        t["self_s"] += (d - covered.get(r.id, 0)) * 1e-9
    return out
