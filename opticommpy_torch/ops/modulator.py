"""Electro-optic modulator transfer functions (port of
``opticommpy_tpu/ops/modulator.py``)."""

import math

import torch

__all__ = ["calc_pm", "calc_mzm"]


def calc_pm(e_in, v_pi, u):
    """Phase modulator: ``E_o = E_i * exp(j*pi*u/Vpi)`` (core.py:1115)."""
    return e_in * torch.exp(1j * ((u / v_pi) * math.pi))


def calc_mzm(e_in, v_pi, u, v_b, er_db):
    """Mach-Zehnder modulator with finite extinction ratio ``er_db`` (core.py:1075).

    Two phase-modulated arms whose imbalance is set by the extinction ratio.
    """
    er_lin = 10 ** (er_db / 10)
    g = 2 * math.sqrt(er_lin) / (er_lin + 1)
    return (math.sqrt(1 + g) * calc_pm(e_in / 2, v_pi, (u + v_b) / 2)
            + math.sqrt(1 - g) * calc_pm(e_in / 2, v_pi, -(u + v_b) / 2))
