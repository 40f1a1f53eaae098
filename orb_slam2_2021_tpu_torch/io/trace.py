"""Spans and counters at the port's stage boundaries, on the clock of the
device trace.

One recorder per process, off until `start()`; `stop()` returns what it
recorded (`Records`). The lane's frame build and tracking, every
acquisition of the map lock (`TracedLock`), the mapping worker and global
BA record spans: name, thread (its native id and the low 32 bits of its
pthread id, signed: the two forms a profiler's runtime events carry as
their thread), start, end, the enclosing span on the same thread, and a
key. The key is the frame id on the lane and the keyframe id on the
mapping worker; a span that does not name one takes its parent's. A
keyframe's creation on the lane (`track.kf_create`) carries the id of the
keyframe it creates, so it and the worker's `mapping.kf` of that keyframe
share one. Counters (`count`) are recorded at the same boundaries, on the
innermost open span.

Off, a call site costs a call and a test: no clock read and no allocation
(`span` returns one shared no-op context). On, nothing waits for the
device: a span stamps the host's clock when the host passes a boundary,
and device time comes from a device trace (torch.profiler) taken beside
the recorder. Records stay in memory until `stop()`.

Stamps are `time.perf_counter_ns()`. `start()` and `stop()` each measure
its offset to the system clock (`time.time_ns()`), which torch.profiler's
events carry, from the narrowest of several bracketing reads;
`Records.offset_ns` is the mean of the two and `Records.offset_err_ns`
bounds its error (the wider bracket's half plus half the drift between
the two). `Records.to_profiler_ns` converts a stamp.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

_clock = time.perf_counter_ns
_OFFSET_READS = 32


class Span(NamedTuple):
    id: int
    parent: int               # the enclosing span on the same thread, -1 at the top
    name: str
    key: Optional[int]        # frame id on the lane, keyframe id on the mapping worker
    tid: int                  # threading.get_native_id()
    tid32: int                # low 32 bits of threading.get_ident(), signed
    t0: int                   # perf_counter ns
    t1: int


class Counter(NamedTuple):
    name: str
    value: float
    key: Optional[int]
    tid: int
    tid32: int
    t: int                    # perf_counter ns
    span: int                 # the innermost open span on the thread, -1 if none


@dataclass
class Records:
    """What one `start()` .. `stop()` recorded."""
    spans: List[Span] = field(default_factory=list)
    counters: List[Counter] = field(default_factory=list)
    t_start: int = 0
    t_stop: int = 0
    offset_ns: int = 0        # system clock - perf_counter
    offset_err_ns: int = 0

    def to_profiler_ns(self, t: int) -> int:
        """A perf_counter stamp on torch.profiler's clock (system ns)."""
        return t + self.offset_ns

    def named(self, name: str, tid: Optional[int] = None) -> List[Span]:
        """The spans of `name`, on the thread of native id `tid` if given."""
        return [s for s in self.spans if s.name == name and (tid is None or s.tid == tid)]

    def seconds_by_key(self, name: str, tid: Optional[int] = None) -> Dict[Optional[int], float]:
        """Seconds spent in spans of `name` (on thread `tid`), summed by key."""
        out: Dict[Optional[int], float] = {}
        for s in self.named(name, tid):
            out[s.key] = out.get(s.key, 0.0) + (s.t1 - s.t0) * 1e-9
        return out


class _Session:
    def __init__(self):
        self.open = True
        self.records = Records()


class _Thread:
    """A thread's open spans [(id, key)] and its two ids."""
    __slots__ = ("stack", "tid", "tid32")

    def __init__(self):
        self.stack = []
        self.tid = threading.get_native_id()
        low = threading.get_ident() & 0xFFFFFFFF
        self.tid32 = low - (1 << 32) if low >= 1 << 31 else low


_session: Optional[_Session] = None
_local = threading.local()
_ids = itertools.count()


def _thread() -> _Thread:
    t = getattr(_local, "t", None)
    if t is None:
        t = _local.t = _Thread()
    return t


def _offset():
    """(system clock - perf_counter, half the bracket) in ns, from the
    narrowest of _OFFSET_READS bracketing reads."""
    best = None
    for _ in range(_OFFSET_READS):
        a = _clock()
        w = time.time_ns()
        b = _clock()
        if best is None or b - a < best[1]:
            best = (w - (a + b) // 2, b - a)
    return best[0], (best[1] + 1) // 2


class _Noop:
    """The span every call site gets while the recorder is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self, t1=None):
        pass


NOOP = _Noop()


class _Span:
    __slots__ = ("session", "name", "key", "id", "parent", "t0", "thread")

    def __init__(self, session: _Session, name: str, key):
        self.session, self.name, self.key = session, name, key

    def open(self, t0: int):
        th = self.thread = _thread()
        self.parent, parent_key = th.stack[-1] if th.stack else (-1, None)
        if self.key is None:
            self.key = parent_key
        self.id = next(_ids)
        th.stack.append((self.id, self.key))
        self.t0 = t0
        return self

    def end(self, t1: Optional[int] = None):
        """Close the span at stamp t1 (now if None); a second call does
        nothing."""
        th = self.thread
        if th is None:
            return
        self.thread = None
        if t1 is None:
            t1 = _clock()
        if th.stack and th.stack[-1][0] == self.id:
            th.stack.pop()
        if self.session.open:
            self.session.records.spans.append(
                Span(self.id, self.parent, self.name, self.key, th.tid, th.tid32, self.t0, t1))

    def __enter__(self):
        return self.open(_clock())

    def __exit__(self, *exc):
        self.end()
        return False


def start():
    """Start recording (process-wide)."""
    global _session
    if _session is not None:
        raise RuntimeError("the recorder is already on")
    s = _Session()
    s.records.offset_ns, s.records.offset_err_ns = _offset()
    s.records.t_start = _clock()
    _session = s


def stop() -> Optional[Records]:
    """Stop recording; returns the records (None when it was off). Spans
    still open are left out."""
    global _session
    s, _session = _session, None
    if s is None:
        return None
    s.open = False
    r = s.records
    r.t_stop = _clock()
    off1, err1 = _offset()
    off0, err0 = r.offset_ns, r.offset_err_ns
    r.offset_ns = (off0 + off1) // 2
    r.offset_err_ns = max(err0, err1) + (abs(off1 - off0) + 1) // 2
    return r


def span(name: str, key: Optional[int] = None):
    """A context that records a span of `name` around its body (the
    parent's key unless `key` is given)."""
    s = _session
    if s is None:
        return NOOP
    return _Span(s, name, key)


def begin(name: str, t0: Optional[int] = None, key: Optional[int] = None):
    """Open a span at a stamp the caller took (perf_counter ns; now if
    None); close it with `.end(t1)`. The shared no-op while off."""
    s = _session
    if s is None:
        return NOOP
    return _Span(s, name, key).open(_clock() if t0 is None else t0)


def stamp() -> Optional[int]:
    """perf_counter ns while on, else None (no clock read)."""
    return _clock() if _session is not None else None


def record(name: str, t0: int, t1: int, key: Optional[int] = None):
    """A closed span [t0, t1] on the calling thread, under its innermost
    open span (an interval that does not nest, such as a queue wait)."""
    s = _session
    if s is None:
        return
    th = _thread()
    parent, parent_key = th.stack[-1] if th.stack else (-1, None)
    s.records.spans.append(Span(next(_ids), parent, name, parent_key if key is None else key,
                                th.tid, th.tid32, t0, t1))


def count(name: str, value):
    """A counter on the calling thread's innermost open span."""
    s = _session
    if s is None:
        return
    th = _thread()
    sid, key = th.stack[-1] if th.stack else (-1, None)
    s.records.counters.append(Counter(name, value, key, th.tid, th.tid32, _clock(), sid))


class TracedLock:
    """A lock whose outermost acquisition on a thread records `lock.wait`
    (from the request to the grant) and `lock.hold` (from the grant to the
    release; spans opened while holding it nest inside) while the
    recorder is on. Re-entry of a reentrant lock records nothing more."""

    def __init__(self, lock):
        self._lock = lock
        self._held = threading.local()

    def __enter__(self):
        if _session is None:
            self._lock.acquire()
            return self
        t0 = _clock()
        self._lock.acquire()
        t1 = _clock()
        h = self._held
        depth = getattr(h, "depth", 0)
        if depth == 0:
            record("lock.wait", t0, t1)
            h.hold = begin("lock.hold", t1)
        h.depth = depth + 1
        return self

    def __exit__(self, *exc):
        h = self._held
        depth = getattr(h, "depth", 0)
        if depth:
            h.depth = depth - 1
            if depth == 1:
                hold, h.hold = h.hold, None
                hold.end()
        self._lock.release()
        return False
