"""Host-side flight recorder: Chrome-trace/Perfetto spans + JSONL events
(the port's own copy of ``repro.telemetry.trace``, which imports no JAX).

One :class:`Recorder` per run.  It buffers three things in memory and
writes them out on :meth:`close`:

* **spans** — ``with rec.span("coord/server_batch"): ...`` records a
  complete ("ph": "X") Chrome trace event with microsecond timestamps;
  ``rec.instant(...)`` records an instant ("ph": "i").  The whole buffer
  serializes to ``trace.json`` in the Chrome trace-event format, loadable
  by Perfetto / chrome://tracing.  Spans measure HOST wall-clock between
  enter and exit — for work on the card that is enqueue time (CUDA launches
  are asynchronous); the recorder never inserts device syncs to "fix"
  that.
* **events** — ``rec.event("run_summary", n_events=..., ...)`` appends one
  structured record to ``events.jsonl`` (one JSON object per line, each
  stamped with seconds-since-recorder-start ``t`` and a ``kind``).
* **counters** — ``rec.count("client/3/drops")`` bumps a named counter;
  the full counter map is flushed as a final ``{"kind": "counters"}``
  JSONL record so reports can build per-client tables.

Spans nest per thread: each complete event's ``args`` carry its ``id`` and
its enclosing span's ``parent`` name and ``parent_id``, and
:meth:`Recorder.totals` sums, per span name, the count, the host seconds
and the self host seconds (a span's own less its children's).

``Recorder(device=True)``, on a CUDA run, also records a pair of
``torch.cuda.Event(enable_timing=True)`` on the current stream at each
span's enter and exit, with no sync; :meth:`Recorder.totals`, called
after the caller has synchronised, adds each name's device seconds (the
stream interval between its two events, idle included).  While a
``torch.profiler`` profile runs such a recorder's spans also enter a
``record_function`` range of their name, so the profiler's trace holds
them on the clock of its device operations.  Only this mode imports
torch.

All methods are thread-safe (the cluster runtime records from coordinator
and client threads) and cheap enough to leave in hot host loops; the
module-level :data:`NULL` recorder turns every call into a no-op so
runners can thread one object through unconditionally.
"""
from __future__ import annotations

import itertools
import json
import os
import pathlib
import threading
import time

TRACE_FILE = "trace.json"
EVENTS_FILE = "events.jsonl"


class _Span:
    """One span's context; appends one complete event on exit."""

    __slots__ = ("rec", "name", "cat", "args", "t0", "id", "parent",
                 "child_s", "events", "range")

    def __init__(self, rec, name, cat, args):
        self.rec, self.name, self.cat, self.args = rec, name, cat, args

    def __enter__(self):
        rec = self.rec
        stack = rec._open_spans()
        self.parent = stack[-1] if stack else None
        self.id = next(rec._ids)
        self.child_s = 0.0
        stack.append(self)
        torch = rec._torch
        if torch is not None:
            if torch.autograd._profiler_enabled():
                self.range = torch.autograd.profiler.record_function(self.name)
                self.range.__enter__()
            else:
                self.range = None
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec._torch is not None:
            self.events[1].record()
            if self.range is not None:
                self.range.__exit__(*exc)
        t1 = time.perf_counter()
        rec._open_spans().pop()
        if self.parent is not None:
            self.parent.child_s += t1 - self.t0
        rec._complete(self, t1)
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Recorder:
    """Buffering trace + JSONL recorder for one run."""

    enabled = True

    def __init__(self, run_dir: str | os.PathLike | None = None, *,
                 device: bool = False):
        self.run_dir = pathlib.Path(run_dir) if run_dir is not None else None
        self._t0 = time.perf_counter()
        self._pid = os.getpid()
        self._trace: list[dict] = []
        self._jsonl: list[str] = []
        self.counters: dict[str, float] = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()
        # per span name: [count, host seconds, self host seconds]
        self._totals: dict[str, list] = {}
        self._device_events: dict[str, list] = {}
        self._torch = None
        if device:
            import torch
            if not torch.cuda.is_available():
                raise ValueError("device=True needs a CUDA device")
            self._torch = torch

    # -- spans -------------------------------------------------------------

    def span(self, name: str, cat: str = "run", **args) -> _Span:
        return _Span(self, name, cat, args)

    def _open_spans(self) -> list:
        """This thread's stack of open spans."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _complete(self, span, t1):
        dur = t1 - span.t0
        args = {"id": span.id}
        if span.parent is not None:
            args["parent"] = span.parent.name
            args["parent_id"] = span.parent.id
        args.update(span.args)
        ev = {"name": span.name, "cat": span.cat, "ph": "X",
              "ts": round((span.t0 - self._t0) * 1e6, 3),
              "dur": round(dur * 1e6, 3),
              "pid": self._pid, "tid": threading.get_ident(), "args": args}
        with self._lock:
            self._trace.append(ev)
            tot = self._totals.setdefault(span.name, [0, 0.0, 0.0])
            tot[0] += 1
            tot[1] += dur
            tot[2] += dur - span.child_s
            if self._torch is not None:
                self._device_events.setdefault(span.name, []).append(
                    span.events)

    def totals(self) -> dict:
        """Per span name: ``count``, ``host_s``, ``self_s`` and
        ``device_s`` (None without device mode), over every span closed so
        far.  In device mode the caller synchronises the device first:
        this reads the events' elapsed times."""
        with self._lock:
            totals = {k: list(v) for k, v in self._totals.items()}
            events = {k: list(v) for k, v in self._device_events.items()}
        out = {}
        for name, (count, host_s, self_s) in totals.items():
            device_s = None
            if self._torch is not None:
                device_s = 1e-3 * sum(s.elapsed_time(e)
                                      for s, e in events[name])
            out[name] = {"count": count, "host_s": host_s,
                         "self_s": self_s, "device_s": device_s}
        return out

    def instant(self, name: str, cat: str = "run", **args) -> None:
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": round((time.perf_counter() - self._t0) * 1e6, 3),
              "pid": self._pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            self._trace.append(ev)

    # -- structured events -------------------------------------------------

    def event(self, kind: str, **fields) -> None:
        rec = {"t": round(time.perf_counter() - self._t0, 6), "kind": kind}
        rec.update(fields)
        line = json.dumps(rec, default=str)
        with self._lock:
            self._jsonl.append(line)

    def count(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    # -- lifecycle ---------------------------------------------------------

    def flush(self) -> list[str]:
        """Write ``trace.json`` + ``events.jsonl`` under ``run_dir`` (no-op
        without one); returns the paths written."""
        if self.run_dir is None:
            return []
        with self._lock:
            if self.counters:
                rec = {"t": round(time.perf_counter() - self._t0, 6),
                       "kind": "counters", "counters": dict(self.counters)}
                self._jsonl.append(json.dumps(rec))
            trace = list(self._trace)
            lines = list(self._jsonl)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        tpath = self.run_dir / TRACE_FILE
        tpath.write_text(json.dumps(
            {"traceEvents": trace, "displayTimeUnit": "ms"}))
        epath = self.run_dir / EVENTS_FILE
        epath.write_text("".join(line + "\n" for line in lines))
        return [str(tpath), str(epath)]

    def close(self) -> list[str]:
        return self.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class NullRecorder(Recorder):
    """Every method a no-op; the default recorder threaded through hot
    loops so call sites need no ``if`` guards."""

    enabled = False

    def __init__(self):
        self.run_dir = None
        self.counters = {}

    def span(self, name, cat="run", **args):
        return _NULL_SPAN

    def instant(self, name, cat="run", **args):
        pass

    def event(self, kind, **fields):
        pass

    def count(self, name, n=1):
        pass

    def totals(self):
        return {}

    def flush(self):
        return []


NULL = NullRecorder()
