"""Reading a ``torch.profiler`` trace of a traced stretch: the card's busy
seconds (the union of its kernels, copies and sets), its kernels' device
time and launches by name, the ten device operations that took most
time, and the idle time by what the host was doing (the innermost
``bench.*`` span of this harness, else ``host``)."""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def events(prof) -> list:
    """The trace's complete events, through its Chrome-trace export (a
    temporary file, removed at once)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    evs = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in evs if e.get("ph") == "X" and "dur" in e]


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def short(name: str) -> str:
    """A kernel's name without its namespace wrappers, template arguments
    and parameters: ``rasterize_fwd_kernel``,
    ``at::native::vectorized_elementwise_kernel``."""
    bare = name.replace("(anonymous namespace)::", "")
    bare = bare[len("void "):] if bare.startswith("void ") else bare
    m = re.match(r"[A-Za-z_][\w:]*", bare)
    return (m.group(0) if m else name)[:80]


def summary(evs: list) -> dict:
    """Busy seconds, the traced span of the device, kernel time and
    launches by kernel name, the top device operations and the idle gaps
    by host span."""
    dev = [e for e in evs if e.get("cat") in DEVICE_CATS]
    spans = [e for e in evs if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("bench.")]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        k = by_name[short(e["name"])]
        k[0] += e["dur"] * 1e-6
        k[1] += 1
    merged = _merge([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    busy = sum(e - s for s, e in merged) * 1e-6
    # the harness's spans follow one another, none inside another
    spans.sort(key=lambda e: e["ts"])
    starts = [e["ts"] for e in spans]
    gaps = defaultdict(float)
    for (_, end), (start, _) in zip(merged, merged[1:]):
        mid = 0.5 * (end + start)
        i = bisect.bisect_right(starts, mid) - 1
        doing = "host"
        if i >= 0 and spans[i]["ts"] + spans[i]["dur"] >= mid:
            doing = spans[i]["name"]
        gaps[doing] += (start - end) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "busy_s": busy,
        "device_span_s": ((merged[-1][1] - merged[0][0]) * 1e-6
                          if merged else 0.0),
        "kernels": {k: tuple(v) for k, v in by_name.items()},
        "device_ops": [[k, v[0]] for k, v in top],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                            key=lambda kv: -kv[1])[:10],
    }
