"""The traced run's device measurements, by ``torch.profiler``.

A bounded number of work units runs under the profiler (CPU and CUDA
activities), with each layer's calls inside a ``pb.<layer>`` range and no
synchronization inside a unit. From the events:

- ``busy_s``: the union of the intervals in which a device operation
  (kernel, copy or fill) ran, over the profiled units;
- ``window_s``: the host-clock length of the profiled units, from a
  synchronized start to a synchronized end;
- ``range_dev_s``: per range, the device time of the operations that
  start inside the range's GPU annotation (the profiler's copy of the
  range on the device timeline, which covers every kernel the range
  launched, those launched through ctypes included; a range's own
  ``device_time_total`` counts only kernels of PyTorch operators), and
  ``range_calls``;
- ``kernel_s``: device seconds by operation name;
- ``idle_gaps``: the device's idle time inside the window, summed by the
  innermost ``pb.`` range the host was in at the gap's middle.

The arithmetic of the busy share and of kernel time by name follows
``tools/profile_torch_main_path.py`` (self device time of the CUDA events).
"""

import time
from collections import defaultdict


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile_units(step, n_units, spans, sync):
    """Run ``step`` ``n_units`` times under the profiler; the summary dict."""
    from torch.profiler import ProfilerActivity, profile

    spans.mode = "profile"
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        for _ in range(n_units):
            step()
        sync()
        window_s = time.perf_counter() - t0
    spans.mode = "off"
    return summarize(prof.events(), window_s, n_units)


def summarize(events, window_s, n_units):
    dev_ops, ranges_cpu, ranges_gpu = [], [], []
    for e in events:
        kind = getattr(e.device_type, "name", str(e.device_type))
        if kind == "CUDA":
            (ranges_gpu if e.name.startswith("pb.") else dev_ops).append(e)
        elif e.name.startswith("pb."):
            ranges_cpu.append(e)
    spans = [(e.time_range.start, e.time_range.end) for e in dev_ops]
    merged = _union(spans)
    busy_s = sum(e - s for s, e in merged) * 1e-6
    kernel_s = defaultdict(float)
    for e in dev_ops:
        kernel_s[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
    range_dev_s, range_calls = defaultdict(float), defaultdict(int)
    for e in ranges_cpu:
        range_calls[e.name[3:]] += 1
    for r in ranges_gpu:
        lo, hi = r.time_range.start, r.time_range.end
        range_dev_s[r.name[3:]] += 1e-6 * sum(e - s for s, e in spans if lo <= s < hi)
    gaps = defaultdict(float)
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        inside = [r for r in ranges_cpu if r.time_range.start <= mid <= r.time_range.end]
        label = (min(inside, key=lambda r: r.time_range.end - r.time_range.start).name
                 if inside else "outside any layer")
        gaps[label] += (s1 - e0) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return dict(busy_s=busy_s, window_s=window_s, units=n_units, kernel_s=dict(kernel_s),
                range_dev_s=dict(range_dev_s), range_calls=dict(range_calls),
                device_ops=top(kernel_s), idle_gaps=top(gaps))
