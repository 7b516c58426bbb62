"""Per-stage timing and device profiling helpers (port of
``opticommpy_tpu/utils/profiling.py``).

- :class:`StageTimer` measures named pipeline stages with correct device
  synchronization (CUDA launches are asynchronous; each stage's result is
  waited for on its device),
- :func:`trace` wraps a region with ``torch.profiler`` and writes a Chrome
  trace of the host ops and, on a card, of the kernels,
- :func:`span` and :func:`count` are the program's own spans and counters.
  They record only while a ``torch.profiler`` records (:func:`trace`, or
  any other profiler a caller opens), never synchronize, and cost one check
  each otherwise. Each span is a profiler range ``pb.<name>``, on the
  kernels' clock, so a trace gives every stage its calls, the device's
  idle gaps while the host was in it and, where the span annotates the
  device, its device time; :func:`counts` reads the counters' totals.

Spans (``*``: host only, ``device=False``): ``rx.front_end`` (children
``rx.front_end.filter*``, ``rx.front_end.edc*``, ``rx.front_end.foe*``,
opened once per signal), ``rx.equalizer``, ``rx.bps`` and ``rx.unwrap`` in
:func:`~opticommpy_torch.pipelines.coherent_dsp_chain_batch`; ``ssfm.span*``
and ``ssfm.amplifier*`` per span of the Manakov solver. Counters, added by
:func:`~opticommpy_torch.comm.fec.decode_ldpc`: ``fec.codewords`` and
``fec.codeword_iters`` (the iterations each codeword ran, summed); by the
Manakov solver (:func:`~opticommpy_torch.models.channels.manakov_ssf`):
``ssfm.calls``, ``ssfm.steps``, ``ssfm.trap_iters`` and ``ssfm.host_syncs``
(``dbp.*`` in digital backpropagation).
"""

import os
import tempfile
import time
from contextlib import contextmanager, nullcontext

import torch

__all__ = ["StageTimer", "trace", "span", "count", "counts", "reset_counts"]

# the namespace in which the repo's trace readers key device time, calls and idle gaps
SPAN_PREFIX = "pb."

_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = nullcontext()
_totals = {}  # counter name -> the values added since the last reset_counts()


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
    Yields the directory. The program's spans (module docstring) show up in
    the trace as ranges ``pb.<name>``, and its counters start from zero
    with the region and add up while it runs (:func:`counts`).
    """
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "opticommpy_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    reset_counts()
    prof.start()
    try:
        yield log_dir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def span(name, device=True):
    """A context manager around one stage of the program: while a
    ``torch.profiler`` records, the profiler range ``pb.<name>``; otherwise
    a shared no-op. It never synchronizes.

    The profiler gives each kernel to the innermost range that annotates
    the device and draws that range on the device timeline from its first
    kernel to its last, so an enclosing range keeps the kernels of its
    children only where it launches kernels of its own before and after
    them. Spans that annotate the device therefore do not nest: spans that
    should only label the host's time inside another (the front end's
    per-signal stages) pass ``device=False``.
    """
    if not _profiler_enabled():
        return _OFF
    if device:
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + name)


def count(name, value):
    """Add ``value`` (a number, or a tensor whose elements count) to the
    counter ``name`` while a ``torch.profiler`` records; otherwise nothing.
    A tensor is kept and summed on its device when the counter is read, so
    a traced region gains no device work and no synchronization."""
    if _profiler_enabled():
        _totals.setdefault(name, []).append(value)


def counts():
    """``{name: total}`` of every counter, as floats (one read from the
    device per counter): all that was counted under any profiler since the
    process started or since the last :func:`reset_counts`, which
    :func:`trace` calls when its region starts."""
    return {name: float(sum(v.sum(dtype=torch.float64) if isinstance(v, torch.Tensor) else v
                            for v in values))
            for name, values in _totals.items()}


def reset_counts():
    """Set every counter back to zero."""
    _totals.clear()
