"""The device's side of a traced stretch: what ran, when, and which layer
launched it.

``device_events`` and ``union_ns`` are copied from
``unet_design_tpu_torch/benchmark/probe.py``.  A kernel's layer comes from
the profiler's link from each kernel to the host call that launched it,
never from the kernel's name: the launch (a CUDA runtime call, linked to
the kernel by its correlation id) lies inside the host events that were
open on its thread, and

- a kernel inside ``aten::convolution`` or ``aten::convolution_backward``
  is a convolution's;
- a kernel inside one of the harness's spans (``h100bench::<layer>``,
  opened around calls into a layer) is that layer's, and so is a kernel of
  the backward of an operation that ran inside the span (matched by the
  autograd sequence number of the forward operation and its thread).
"""

from __future__ import annotations

import bisect
import collections
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

SPAN = "h100bench::"
CONV_OPS = ("aten::convolution", "aten::convolution_backward")


def device_events(prof) -> list:
    """``(name, start_ns, end_ns)`` of what the device ran in a profile:
    kernels, copies and sets.  Annotations on the device's timeline span
    other kernels and are left out; an event recorded twice counts once."""
    from torch.autograd import DeviceType

    def annotation(e):
        # the event's own flag where this PyTorch's profiler has it
        flag = getattr(e, "is_user_annotation", None)
        kind = getattr(e, "activity_type", None)
        return bool((flag is not None and flag()) or (
            kind is not None and "annotation" in str(kind()).lower()))
    seen = set()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or annotation(e):
            continue
        stream = getattr(e, "device_resource_id", lambda: 0)()
        seen.add((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                  stream))
    return sorted((n, s, t) for n, s, t, _ in seen)


def union_ns(intervals) -> int:
    """Length of the union of ``(start, end)`` intervals: device time with
    kernels that overlap (other streams) counted once."""
    total, end = 0, None
    for s, t in sorted(intervals):
        if end is None or s > end:
            total += t - s
            end = t
        elif t > end:
            total += t - end
            end = t
    return total


def gaps(intervals: Iterable[Tuple[int, int]], lo: int, hi: int
         ) -> List[Tuple[int, int]]:
    """The idle ``(start, end)`` stretches of ``[lo, hi]`` outside the
    union of ``intervals``."""
    out, at = [], lo
    for s, t in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, t)
    if at < hi:
        out.append((at, hi))
    return [(s, t) for s, t in out if t > s]


class HostEvent:
    __slots__ = ("name", "start", "end", "thread", "seq", "fwd_thread",
                 "backward", "corr", "parent")

    def __init__(self, name, start, end, thread, seq=-1, fwd_thread=0,
                 backward=False, corr=0):
        self.name, self.start, self.end = name, start, end
        self.thread, self.seq, self.fwd_thread = thread, seq, fwd_thread
        self.backward, self.corr = backward, corr
        self.parent = None

    def outer(self) -> List["HostEvent"]:
        """This event and the events open around it, innermost first."""
        out, h = [], self
        while h is not None:
            out.append(h)
            h = h.parent
        return out


class Kernel:
    __slots__ = ("name", "start", "end", "corr", "link")

    def __init__(self, name, start, end, corr, link=0):
        self.name, self.start, self.end, self.corr = name, start, end, corr
        self.link = link


def nest(host: Sequence[HostEvent]) -> Dict[int, List[HostEvent]]:
    """Set each host event's ``parent`` (the innermost event of its thread
    open around it); returns each thread's events by start."""
    by_thread: Dict[int, List[HostEvent]] = collections.defaultdict(list)
    for h in host:
        by_thread[h.thread].append(h)
    for evs in by_thread.values():
        evs.sort(key=lambda h: (h.start, -h.end))
        stack: List[HostEvent] = []
        for h in evs:
            while stack and (h.start >= stack[-1].end
                             or h.end > stack[-1].end):
                stack.pop()
            h.parent = stack[-1] if stack else None
            stack.append(h)
    return by_thread


def _raw(prof) -> Tuple[List[HostEvent], List[Kernel]]:
    """Host events (operations, spans, runtime calls) and device kernels of
    a profile, in nanoseconds on the profiler's clock."""
    from torch.autograd import DeviceType
    host, dev = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        t = s + e.duration_ns()
        corr = getattr(e, "correlation_id", lambda: 0)()
        if e.device_type() == DeviceType.CUDA:
            dev.append(Kernel(e.name(), s, t, corr, getattr(
                e, "linked_correlation_id", lambda: 0)()))
        elif e.device_type() == DeviceType.CPU:
            host.append(HostEvent(
                e.name(), s, t, e.start_thread_id(),
                getattr(e, "sequence_nr", lambda: -1)(),
                getattr(e, "fwd_thread_id", lambda: 0)(),
                getattr(e, "scope", lambda: 0)() == 1, corr))
    return host, dev


def _is_runtime(name: str) -> bool:
    return name.startswith(("cuda", "cu"))


def _span_of(chain: Sequence[HostEvent]) -> Optional[str]:
    for o in chain:
        if o.name.startswith(SPAN):
            return o.name[len(SPAN):]
    return None


def classify(host: Sequence[HostEvent], dev: Sequence[Kernel]
             ) -> Dict[str, float]:
    """Seconds of device time by layer (``conv`` and each span's name;
    the rest under ``other``) of ``dev``, linked to ``host`` as the
    module's docstring says."""
    nest(host)
    # runtime launches by correlation id (a kernel shares its launch's);
    # else the operation the kernel's linked id names
    launches = {h.corr: h for h in host if h.corr and _is_runtime(h.name)}
    ops = {h.corr: h for h in host if h.corr and not _is_runtime(h.name)}
    # forward operations inside a span, by (sequence number, thread)
    fwd_layer: Dict[Tuple[int, int], str] = {}
    for h in host:
        if h.seq >= 0 and not h.backward:
            layer = _span_of(h.outer())
            if layer:
                fwd_layer[(h.seq, h.thread)] = layer
    out: Dict[str, float] = collections.defaultdict(float)
    for k in dev:
        launch = launches.get(k.corr) or ops.get(k.link)
        layer = None
        if launch is not None:
            chain = launch.outer()
            layer = _span_of(chain)
            if layer is None:
                for o in chain:
                    if o.backward and (o.seq, o.fwd_thread) in fwd_layer:
                        layer = fwd_layer[(o.seq, o.fwd_thread)]
                        break
            if layer is None and any(o.name in CONV_OPS for o in chain):
                layer = "conv"
        out[layer or "other"] += (k.end - k.start) / 1e9
    return dict(out)


def top_ops(dev: Sequence[Tuple[str, int, int]], n: int = 10
            ) -> List[list]:
    """The ``n`` device operations that took most time, summed by name."""
    tot: Dict[str, float] = collections.defaultdict(float)
    for name, s, t in dev:
        tot[name] += (t - s) / 1e9
    return [[k[:120], v] for k, v in sorted(tot.items(),
                                           key=lambda kv: -kv[1])[:n]]


def idle_by_host(host: Sequence[HostEvent], idle: Sequence[Tuple[int, int]],
                 n: int = 10) -> List[list]:
    """The idle time of ``idle``, by what the host's main thread (the one
    with the most events) was doing at the middle of each gap: its
    innermost open operation or span, or ``python`` where none was open;
    the ``n`` largest."""
    by_thread = nest([h for h in host if not _is_runtime(h.name)])
    if not by_thread:
        return []
    evs = max(by_thread.values(), key=len)
    starts = [h.start for h in evs]
    tot: Dict[str, float] = collections.defaultdict(float)
    for s, t in idle:
        mid = (s + t) // 2
        i = bisect.bisect_right(starts, mid)
        h = evs[i - 1] if i else None
        while h is not None and h.end < mid:
            h = h.parent
        tot[h.name[:120] if h else "python"] += (t - s) / 1e9
    return [[k, v] for k, v in sorted(tot.items(),
                                      key=lambda kv: -kv[1])[:n]]


class Stretch:
    """A profiled stretch: started and stopped after a synchronisation.
    ``host`` records the host's operations too (for the layers and the
    host's side of the gaps); without it the profiler records the device
    alone and leaves the host's pace as it is.  What it recorded is read
    as it stops, before another profiler session can reuse the
    profiler's buffers."""

    def __init__(self, host: bool):
        self.host = host
        self.prof = None
        self.t0 = self.t1 = None
        self.events: list = []        # device_events()
        self.raw = ([], [])           # _raw(), for a host stretch

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = []
        if self.host or not torch.cuda.is_available():
            acts.append(ProfilerActivity.CPU)
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter_ns()

    def stop(self) -> None:
        self.t1 = time.perf_counter_ns()
        self.prof.__exit__(None, None, None)
        self.events = device_events(self.prof)
        if self.host:
            self.raw = _raw(self.prof)
        self.prof = None


class Traced:
    """The traced part of a run, after its window: ``steps`` steps with the
    device alone recorded (busy seconds with overlaps once, over the
    stretch's wall; the operations that took most time), then ``steps``
    more with the host recorded too and the layer spans open (device
    seconds by layer; the host's operations in the device's gaps).  Call
    :meth:`begin` and then :meth:`step` after every step until it returns
    True.  A profiler session on the card now and then records no device
    event; such a stretch is recorded again, up to ``tries`` times."""

    def __init__(self, steps: int, sync, spans=None, tries: int = 3):
        self.steps, self.sync, self.spans = steps, sync, spans
        self.tries = tries
        self.device, self.host = Stretch(False), Stretch(True)
        self.count = 0
        self._spans = None

    def begin(self) -> None:
        self.sync()
        self.device.start()

    def _empty(self, stretch: Stretch) -> bool:
        """No device event recorded where a card is there to record."""
        return torch.cuda.is_available() and not stretch.events

    def step(self) -> bool:
        self.count += 1
        if self.count == self.steps:
            self.sync()
            self.device.stop()
            if self._empty(self.device) and self.tries > 1:
                self.tries -= 1
                self.count = 0
                self.device = Stretch(False)
                self.device.start()
                return False
            if self.spans is not None:
                self._spans = self.spans()
                self._spans.__enter__()
            self.host.start()
        elif self.count == 2 * self.steps:
            self.sync()
            self.host.stop()
            if self._empty(self.host) and self.tries > 1:
                self.tries -= 1
                self.count = self.steps
                self.host = Stretch(True)
                self.host.start()
                return False
            self.close()
            return True
        return False

    def close(self) -> None:
        if self._spans is not None:
            self._spans.__exit__(None, None, None)
            self._spans = None

    @property
    def done(self) -> bool:
        return self.host.t1 is not None

    def read(self) -> Dict[str, object]:
        ev = self.device.events
        busy = union_ns((s, t) for _, s, t in ev) / 1e9
        wall = (self.device.t1 - self.device.t0) / 1e9
        hev = self.host.events
        host, dev = self.host.raw
        lo = min([h.start for h in host] + [s for _, s, _ in hev])
        hi = max([h.end for h in host] + [t for _, _, t in hev])
        idle = gaps([(s, t) for _, s, t in hev], lo, hi)
        return {"busy_s": busy, "window_s": wall,
                "layers": classify(host, dev),
                "breakdown": {"device_ops": top_ops(ev),
                              "idle_gaps": idle_by_host(host, idle)}}


def span(name: str):
    """A span of the harness around a call into a layer."""
    return torch.profiler.record_function(SPAN + name)
