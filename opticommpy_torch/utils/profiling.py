"""Per-stage timing and device profiling helpers (port of
``opticommpy_tpu/utils/profiling.py``).

- :class:`StageTimer` measures named pipeline stages with correct device
  synchronization (CUDA launches are asynchronous; each stage's result is
  waited for on its device),
- :func:`trace` wraps a region with ``torch.profiler`` and writes a Chrome
  trace of the host ops and, on a card, of the kernels.
"""

import os
import tempfile
import time
from contextlib import contextmanager

import torch

__all__ = ["StageTimer", "trace"]


def _cuda_devices(x, out):
    """The CUDA devices of every tensor in a nest of tensors."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)
    return out


class StageTimer:
    """Accumulates wall-clock timings of named stages.

    >>> timer = StageTimer()
    >>> with timer("edc"):
    ...     out = timer.sync(edc(sig, cfg))
    >>> print(timer.table())
    """

    def __init__(self):
        self.times = {}

    @contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        yield
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    @staticmethod
    def sync(x):
        """Wait for all device work feeding ``x`` (use inside a stage block):
        synchronizes each CUDA device that holds a tensor of ``x``."""
        for dev in _cuda_devices(x, set()):
            torch.cuda.synchronize(dev)
        return x

    def table(self):
        total = sum(self.times.values()) or 1.0
        lines = [f"{'stage':<24} {'time [s]':>10} {'share':>8}"]
        for name, t in sorted(self.times.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:<24} {t:>10.3f} {100 * t / total:>7.1f}%")
        lines.append(f"{'total':<24} {total:>10.3f}")
        return "\n".join(lines)


@contextmanager
def trace(log_dir=None):
    """Capture a ``torch.profiler`` trace of the enclosed region.

    Writes ``<log_dir>/trace.json`` (Chrome trace format; open it in
    Perfetto or ``chrome://tracing``) when the region ends. ``log_dir``
    defaults to ``opticommpy_torch_trace`` in the temporary directory.
    Yields the directory.
    """
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "opticommpy_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
