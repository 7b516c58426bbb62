"""The least work of the adaptive-step Manakov solver (``manakov_ssf`` with
``nlprMethod``), from the steps and trapezoidal passes it ran.

Each step takes the field to the frequency domain and back once for its
first linear half-step, and once more for each trapezoidal pass (the
rotated field through the second half-step): one forward and one inverse
FFT per polarization, 5 N log2 N floating-point operations each (the
radix-2 count). The field (complex64) is read once and written once a
call. The step-size rule's reduction, the rotations, the convergence
tests and the ASE are left out, so the count is below the solver's work.
"""

from harness import core


def manakov_nlpr(n_samples, steps, passes, modes=2):
    """(flops, bytes) of one call that ran ``steps`` steps and ``passes``
    trapezoidal passes on ``modes`` polarizations of ``n_samples``."""
    fft = core.counts("ssfm").fft_flops(n_samples)
    return (steps + passes) * modes * 2 * fft, 2 * n_samples * modes * 8
