"""Plain reference of the 11-channel coherent WDM link with OptiCommPy's own
Manakov solver: ``manakovSSF`` with ``nlprMethod=True``, each step sized
by the peak nonlinear phase rotation, the trapezoid iterated to ``tol``.

Plain PyTorch. It imports nothing of the program under test and nothing
of JAX. The Tx, the receivers, the DSP and the scoring are those of the
fixed-step link's reference (``wdm11_16qam_5x50km.py``, loaded from its
file beside this one); only the fibre is new. Per span, while z < Lspan:

- ``Pch = |Ex|^2 + |Ey|^2``; ``phiRot = (8/9) gamma (Pch + |Ex|^2 + |Ey|^2) / 2``
  (``nlinPhaseRot``, here ``(8/9) gamma Pch``);
- ``hz = maxNlinPhaseRot / max(phiRot)``, cut to ``Lspan - z``;
- the first linear half-step ``E_hd = ifft(fft(E) L)``, with
  ``L = exp((-alpha/2 + j beta2/2 w^2) hz/2)``;
- trapezoidal passes, at most ``maxIter``: ``E_fd = ifft(fft(E_hd
  exp(j phiRot hz)) L)``, then the change ``||E_fd - E_conv|| / ||E_conv||``
  over both polarizations; ``E_conv = E_fd`` and ``phiRot`` from ``Pch`` and
  ``E_fd``; the passes stop when the change is below ``tol``;
- ``z += hz``;

then the span's amplifier: an EDFA of gain ``alpha Lspan`` dB with ASE of
``(G-1) nsp h Fc`` over the simulation bandwidth, an ideal gain, or none.
The linear operators are formed in float64 and rounded to complex64; the
field is complex64 throughout.

Departures from OptiCommPy's ``manakovSSF``:

- ``z`` and ``hz`` are float32, the precision of the field's real part
  (OptiCommPy's are Python floats);
- the first pass is compared with the field at the start of the step,
  where OptiCommPy compares nothing after its first pass. The first pass
  always moves the field by far more than ``tol``, so the passes run are
  OptiCommPy's;
- the ASE is drawn from a ``torch.Generator``.

:func:`manakov` returns the field with the steps and passes it ran;
:func:`link` keeps those of its last call in :data:`last_counts`.
``rnd`` rounds every stored intermediate, as in the fixed-step reference
(:func:`bf16` for the control).
"""

import importlib.util
import math
import os
import sys

import numpy as np
import torch

# float32 products in float32, never TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _fixed_step_reference():
    """The fixed-step link's reference module, loaded once from its file."""
    name = "portbench_reference_wdm11_16qam_5x50km"
    if name not in sys.modules:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "wdm11_16qam_5x50km.py")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


_fixed = _fixed_step_reference()
ident, bf16, bf16_np = _fixed.ident, _fixed.bf16, _fixed.bf16_np
qam16_gray, tx, fiber_consts = _fixed.qam16_gray, _fixed.tx, _fixed.fiber_consts
receive_all, align_symbols, da_snr = _fixed.receive_all, _fixed.align_symbols, _fixed.da_snr
best_lag, dsp, scores = _fixed.best_lag, _fixed.dsp, _fixed.scores

last_counts = {}  # {"steps": ..., "passes": ...} of the last call of link()


def _rotation(ex, ey, pch, gamma):
    return (8 / 9) * gamma * (pch + torch.abs(ex) ** 2 + torch.abs(ey) ** 2) / 2


def _change(e_fd, e_conv):
    return torch.sqrt(torch.sum(torch.abs(e_fd - e_conv) ** 2)) / torch.sqrt(
        torch.sum(torch.abs(e_conv) ** 2))


def _span(e, arg, fib, rnd):
    """One span of the (2, N) field: (field, steps, passes)."""
    fft = lambda x: torch.fft.fft(x, dim=-1)  # noqa: E731
    ifft = lambda x: torch.fft.ifft(x, dim=-1)  # noqa: E731
    z = torch.zeros((), dtype=torch.float32, device=e.device)
    span_len = torch.tensor(fib["Lspan"], dtype=torch.float32, device=e.device)
    steps = passes = 0
    while bool(z < span_len):
        pch = torch.abs(e[0]) ** 2 + torch.abs(e[1]) ** 2
        phi = _rotation(e[0], e[1], pch, fib["gamma"])
        hz = torch.minimum(fib["maxNlinPhaseRot"] / torch.max(phi), span_len - z)
        lin = torch.exp(arg * (hz.double() / 2)).to(torch.complex64)
        e_hd = rnd(ifft(rnd(fft(e) * lin)))
        e_conv, n, change = e, 0, math.inf
        while n < fib["maxIter"] and change >= fib["tol"]:
            rot = torch.exp(1j * (phi * hz))
            e_fd = rnd(ifft(rnd(fft(rnd(e_hd * rot)) * lin)))
            change = float(_change(e_fd, e_conv))
            e_conv = e_fd
            phi = _rotation(e_fd[0], e_fd[1], pch, fib["gamma"])
            n += 1
        e = e_conv
        z = z + hz
        steps += 1
        passes += n
    return e, steps, passes


def manakov(e_in, fib, fs, gen, rnd=ident):
    """The (N, 2) field through ``Ltotal / Lspan`` spans, each followed by
    its amplifier (``fib["amp"]``: 'edfa', with ASE drawn from ``gen``,
    'ideal' or 'none'): (field (N, 2), steps, trapezoidal passes)."""
    alpha, beta2 = fiber_consts(fib)
    n = e_in.shape[0]
    dev = e_in.device
    w = 2 * np.pi * fs * torch.fft.fftfreq(n, d=1.0, device=dev, dtype=torch.float64)
    arg = torch.complex(torch.full_like(w, -alpha / 2), beta2 / 2 * w * w)
    g_db, nf = fib["alpha"] * fib["Lspan"], 10 ** (fib["NF"] / 10)
    g = 10 ** (g_db / 10)
    nsp = (g * nf - 1) / (2 * (g - 1))
    std = math.sqrt((g - 1) * nsp * _fixed.H_PLANCK * fib["Fc"] * fs / 2)
    e = rnd(e_in.T.contiguous().to(torch.complex64))  # (2, N)
    steps = passes = 0
    for _ in range(int(fib["Ltotal"] // fib["Lspan"])):
        e, s, p = _span(e, arg, fib, rnd)
        steps, passes = steps + s, passes + p
        if fib["amp"] == "edfa":
            e = rnd(e * math.sqrt(g)
                    + torch.complex(std * torch.randn(e.shape, generator=gen, device=dev),
                                    std * torch.randn(e.shape, generator=gen, device=dev)))
        elif fib["amp"] == "ideal":
            e = rnd(e * math.exp(alpha / 2 * fib["Lspan"]))
    return e.T, steps, passes


def link(symbols, pn, cfg, gen, rnd=ident):
    """The whole link for one realization: received signals and aligned
    symbols; its solver's steps and passes go to :data:`last_counts`."""
    txc = cfg["tx"]
    fs = txc["Rs"] * txc["SpS"]
    sig = tx(symbols, pn, txc, rnd)
    sig, steps, passes = manakov(sig, cfg["fiber"], fs, gen, rnd)
    last_counts.update(steps=steps, passes=passes)
    return receive_all(sig, symbols, cfg, gen, rnd)
