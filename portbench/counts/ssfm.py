"""The least work of the fixed-step Manakov split-step solver.

Every step needs each polarization's field in the time domain (for the
nonlinear rotation, which couples them) and in the frequency domain (for
dispersion): one forward and one inverse FFT per polarization and step,
5 N log2 N floating-point operations each (the radix-2 count). The field
(complex64) is read once and written once. Nothing else is counted: the
elementwise products, the amplifier noise and any re-reading of the field
are above the least.
"""

import math


def fft_flops(n):
    return 5 * n * math.log2(n)


def manakov(n_samples, n_steps, modes=2):
    """(flops, bytes) of one call over ``n_steps`` steps of ``n_samples``."""
    return n_steps * modes * 2 * fft_flops(n_samples), 2 * n_samples * modes * 8


def link_steps(fiber):
    """Steps of a link: spans x steps per span."""
    return int(fiber["Ltotal"] // fiber["Lspan"]) * int(round(fiber["Lspan"] / fiber["hz"]))
