"""Profiled sub-windows of a traced run, read into the numbers the
per-layer metrics and the result's ``breakdown`` take.

``profile(device, body)`` runs ``body`` twice, each time between two
synchronises; the drivers call it after the timed window has closed, so
it costs that window nothing.

- The first pass profiles the device alone (``torch.profiler`` with CUDA
  activity only, no host operators recorded, after a profile of one small
  operation has set the profiler up). Its length is the host clock's
  between the two synchronises; the device's busy time is the union of
  the device activity intervals in it; ``device_ops`` are the device
  operations that took the most time. The profiler still costs the host
  some time a launch, so a driver that reads the device's idle share of
  its timed window takes the busy seconds a unit of work from here.
- The second pass adds the host's operators, which slow the host, and is
  read only for ``idle_gaps``: the longest gaps on the device, each named
  by the harness span (``pb.*``, ``record_function``) and the host
  operation that were running at its middle.

Without a card ``body`` runs once and nothing is read.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import torch

TOP = 10


def _annotation(e) -> bool:
    """A ``record_function`` range, which the profiler also mirrors onto
    the device's timeline: no device work of its own."""
    name = getattr(e, "key", None) or e.name
    return bool(getattr(e, "is_user_annotation", False)) or name.startswith("pb.")


def _device_events(prof):
    from torch.autograd import DeviceType

    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and not _annotation(e)]


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _innermost(events, t: float, prefix: Optional[str]) -> str:
    best = None
    for e in events:
        name = e.name
        if prefix is not None and not name.startswith(prefix):
            continue
        if prefix is None and name.startswith("pb."):
            continue
        r = e.time_range
        if r.start <= t <= r.end and (best is None
                                      or r.end - r.start < best[1]):
            best = (name, r.end - r.start)
    return best[0] if best else "-"


def profile(device: torch.device, body: Callable[[], None]) -> dict:
    """``{"window_s", "busy_s" (None without device activity),
    "device_ops", "idle_gaps"}``; the two lists are ``[name, seconds]``,
    ten at most."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda *a: None)
    out = {"window_s": None, "busy_s": None, "device_ops": [], "idle_gaps": []}
    if device.type != "cuda":
        t0 = time.perf_counter()
        body()
        out["window_s"] = time.perf_counter() - t0
        return out

    with torch_profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        sync(device)
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        sync(device)
        t0 = time.perf_counter()
        body()
        sync(device)
        out["window_s"] = time.perf_counter() - t0
    dev = [(e.time_range.start, e.time_range.end) for e in _device_events(prof)]
    dev = [(s, e) for s, e in dev if e > s]
    if not dev:
        return out
    out["busy_s"] = sum(e - s for s, e in _union(dev)) / 1e6
    out["device_ops"] = device_ops(prof)

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        sync(device)
        with record_function("pb.window"):
            body()
            sync(device)
    out["idle_gaps"] = idle_gaps(prof)
    return out


def device_ops(prof) -> list:
    from torch.autograd import DeviceType

    ops = []
    for a in prof.key_averages():
        if getattr(a, "device_type", None) != DeviceType.CUDA or _annotation(a):
            continue
        t = getattr(a, "self_device_time_total", None)
        if t is None:
            t = a.self_cuda_time_total
        ops.append((a.key, t / 1e6))
    ops.sort(key=lambda kv: -kv[1])
    return [[k, v] for k, v in ops[:TOP]]


def idle_gaps(prof) -> list:
    """The longest gaps between device operations inside the profile's
    ``pb.window`` span, each named by what the host was running."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    win = [e for e in events if e.name == "pb.window"
           and e.device_type != DeviceType.CUDA]
    if not win:
        return []
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
           for e in _device_events(prof)]
    busy = _union([(s, e) for s, e in dev if e > s])
    gaps, prev = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps.sort(key=lambda g: -(g[1] - g[0]))
    cpu = [e for e in events if e.device_type != DeviceType.CUDA
           and e.name != "pb.window"]
    out = []
    for s, e in gaps[:TOP]:
        mid = 0.5 * (s + e)
        label = f"{_innermost(cpu, mid, 'pb.')} / {_innermost(cpu, mid, None)}"
        out.append([label, (e - s) / 1e6])
    return out
