"""Visualization helpers: constellations, eye diagrams, PSDs, decision
regions (port of ``opticommpy_tpu/plot.py``).

Host-side matplotlib: each function takes tensors (or arrays) and pulls
them to the host once. ``import opticommpy_torch`` does not import this
module, so matplotlib is needed only by those who plot. Density rendering
uses ``hist2d``/``hexbin``.

Reference citations: pconst (plot.py:38), constHist (:179), plotColoredConst
(:217), plotDecisionBoundaries (:288), eyediagram (:380), plotPSD (:476),
animateConstGIF (:535).
"""

import matplotlib

matplotlib.use("Agg")  # headless by default; callers may switch backends

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from opticommpy_torch.comm.modulation import _host, detector, gray_mapping  # noqa: E402

__all__ = [
    "pconst",
    "const_hist",
    "plot_colored_const",
    "plot_decision_boundaries",
    "eyediagram",
    "plot_psd",
    "animate_const_gif",
    "osa",
]


def _pnorm(x):
    return x / np.sqrt(np.mean(np.abs(x) ** 2))


def _decide(symb, noise_var, const, px, rule):
    """Detector indices of host symbols, on CPU tensors."""
    px = None if px is None else torch.as_tensor(_host(px))
    _, ind = detector(torch.as_tensor(symb), noise_var, torch.as_tensor(const), px=px,
                      rule=rule)
    return ind.numpy()


def osa(x, fs, fc=193.1e12, ax=None):
    """Optical spectrum analyzer plot per polarization (amplification.py:59).

    Renders magnitude spectra in dBm against wavelength.
    """
    from opticommpy_torch.models.amplification import get_spectrum

    x = _host(x)
    if x.ndim == 1:
        x = x[:, None]
    if ax is None:
        _, ax = plt.subplots(1)
    labels = ["X Pol.", "Y Pol."]
    for k in range(min(x.shape[1], 2)):
        lam, spec = get_spectrum(torch.as_tensor(np.ascontiguousarray(x[:, k])), fs, fc)
        ax.plot(1e9 * lam.numpy(), spec.numpy(), label=labels[k],
                alpha=1.0 if k == 0 else 0.5)
    ax.set_xlabel("Wavelength [nm]")
    ax.set_ylabel("Magnitude [dBm]")
    ax.legend()
    ax.grid(True, alpha=0.3)
    return ax


def _to_cols(x):
    x = _host(x)
    return x[:, None] if x.ndim == 1 else x


def pconst(x, lim=True, r=None, density=False, ax=None, **kwargs):
    """Constellation scatter plot, optionally density-shaded (plot.py:38).

    ``x`` may be a tensor or a list of tensors (overlaid).
    """
    sigs = [_to_cols(s) for s in (x if isinstance(x, (list, tuple)) else [x])]
    if ax is None:
        _, ax = plt.subplots(1)
    for sig in sigs:
        for k in range(sig.shape[1]):
            z = sig[:, k]
            if density:
                ax.hexbin(z.real, z.imag, gridsize=80, mincnt=1, cmap="turbo")
            else:
                ax.plot(z.real, z.imag, ".", markersize=3, **kwargs)
    if r is None:
        r = 1.2 * float(max(np.max(np.abs(s)) for s in sigs))
    if lim:
        ax.set_xlim(-r, r)
        ax.set_ylim(-r, r)
    ax.set_xlabel("In-Phase (I)")
    ax.set_ylabel("Quadrature (Q)")
    ax.set_aspect("equal")
    ax.grid(True, alpha=0.3)
    return ax


def const_hist(symb, ax=None, bins=256, radius=1.5):
    """2-D histogram ("density") constellation plot (plot.py:179)."""
    symb = _host(symb).reshape(-1)
    if ax is None:
        _, ax = plt.subplots(1)
    ax.hist2d(
        symb.real, symb.imag, bins=bins,
        range=[[-radius, radius], [-radius, radius]], cmap="turbo", cmin=1,
    )
    ax.set_xlabel("In-Phase (I)")
    ax.set_ylabel("Quadrature (Q)")
    ax.set_aspect("equal")
    return ax


def plot_colored_const(symb, M, const_type, noise_var=0.01, rule="MAP",
                       px=None, ax=None):
    """Constellation colored by detected symbol decision (plot.py:217)."""
    symb = _pnorm(_host(symb).reshape(-1))
    const = _pnorm(gray_mapping(M, const_type))
    ind = _decide(symb, noise_var, const, px, rule)
    if ax is None:
        _, ax = plt.subplots(1)
    cmap = plt.get_cmap("turbo", M)
    ax.scatter(symb.real, symb.imag, c=ind, cmap=cmap, s=4)
    ax.plot(const.real, const.imag, "k+", markersize=8)
    ax.set_xlabel("In-Phase (I)")
    ax.set_ylabel("Quadrature (Q)")
    ax.set_aspect("equal")
    return ax


def plot_decision_boundaries(M, const_type, noise_var=0.01, rule="MAP", px=None,
                             grid=300, radius=1.6, ax=None):
    """MAP/ML decision-region contours over the complex plane (plot.py:288)."""
    const = _pnorm(gray_mapping(M, const_type))
    xs = np.linspace(-radius, radius, grid)
    zz = xs[None, :] + 1j * xs[:, None]
    regions = _decide(zz.reshape(-1), noise_var, const, px, rule).reshape(grid, grid)
    if ax is None:
        _, ax = plt.subplots(1)
    ax.contourf(xs, xs, regions, levels=M, cmap="turbo", alpha=0.3)
    ax.plot(const.real, const.imag, "k+", markersize=8)
    ax.set_xlabel("In-Phase (I)")
    ax.set_ylabel("Quadrature (Q)")
    ax.set_aspect("equal")
    return ax


def eyediagram(sig, n_samples=None, sps=2, n_traces=500, style="fast", ax=None):
    """Eye diagram over 2-symbol traces (plot.py:380).

    style 'fast' overlays line traces; 'fancy' renders a 2-D histogram.
    """
    sig = _host(sig)
    if sig.ndim > 1:
        sig = sig[:, 0]
    if np.iscomplexobj(sig):
        sig = sig.real
    if n_samples:
        sig = sig[:n_samples]
    span = 2 * sps
    n_tr = min(n_traces, len(sig) // span - 1)
    traces = sig[: n_tr * span].reshape(n_tr, span)
    t = np.arange(span) / sps
    if ax is None:
        _, ax = plt.subplots(1)
    if style == "fancy":
        tt = np.tile(t, n_tr)
        ax.hist2d(tt, traces.reshape(-1), bins=[span * 8, 128], cmap="turbo",
                  cmin=1)
    else:
        ax.plot(t, traces.T, color="tab:blue", alpha=0.08, linewidth=0.8)
    ax.set_xlabel("Time [symbol periods]")
    ax.set_ylabel("Amplitude")
    ax.grid(True, alpha=0.3)
    return ax


def plot_psd(sig, fs=1.0, fc=0.0, nfft=4096, ax=None, **kwargs):
    """Welch power spectral density in dB (plot.py:476)."""
    sig = _to_cols(sig)
    if ax is None:
        _, ax = plt.subplots(1)
    for k in range(sig.shape[1]):
        ax.psd(
            sig[:, k], Fs=fs, Fc=fc, NFFT=nfft, sides="twosided", **kwargs
        )
    ax.set_ylabel("PSD [dB/Hz]")
    return ax


def animate_const_gif(symb_frames, filename, fps=5, radius=1.6):
    """Animated GIF of a constellation over time windows (plot.py:535).

    ``symb_frames`` is a sequence of 1-D complex tensors (one per frame).
    Requires pillow (matplotlib's default GIF writer).
    """
    from matplotlib.animation import FuncAnimation, PillowWriter

    frames = [_host(f).reshape(-1) for f in symb_frames]
    fig, ax = plt.subplots(1)
    scat = ax.plot([], [], ".", markersize=3)[0]
    ax.set_xlim(-radius, radius)
    ax.set_ylim(-radius, radius)
    ax.set_aspect("equal")
    ax.grid(True, alpha=0.3)

    def update(i):
        scat.set_data(frames[i].real, frames[i].imag)
        ax.set_title(f"frame {i + 1}/{len(frames)}")
        return (scat,)

    anim = FuncAnimation(fig, update, frames=len(frames))
    anim.save(filename, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return filename
