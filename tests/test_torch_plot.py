"""The port's plotting helpers (opticommpy_torch.plot, comm.fec
.plot_binary_matrix) on tensor inputs, headless (Agg); the drawn data
against the JAX package's plots of the same NumPy inputs where the plot
carries it. ``import opticommpy_torch`` must not import matplotlib."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import matplotlib  # noqa: E402

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from opticommpy_tpu import plot as jplot  # noqa: E402
from opticommpy_tpu.comm import fec as jfec  # noqa: E402
from opticommpy_torch import plot as tplot  # noqa: E402
from opticommpy_torch.comm import fec as tfec  # noqa: E402

from _torch_parity import cpu, noisy_symbols, norm_qam  # noqa: E402

SYM = noisy_symbols(0, 2048, 2, norm_qam(16), snr_db=18.0)


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _lines(ax):
    return [np.asarray(line.get_xydata()) for line in ax.get_lines()]


@pytest.mark.parametrize("density", [False, True])
def test_pconst(density):
    ax = tplot.pconst([cpu(SYM), cpu(SYM[:, 0])], density=density)
    want = jplot.pconst([SYM, SYM[:, 0]], density=density)
    assert ax.get_xlim() == pytest.approx(want.get_xlim())
    for a, b in zip(_lines(ax), _lines(want)):
        np.testing.assert_array_equal(a, b)


def test_const_hist_and_psd():
    assert tplot.const_hist(cpu(SYM)).get_xlabel() == "In-Phase (I)"
    ax = tplot.plot_psd(cpu(SYM), fs=64e9, nfft=256)
    want = jplot.plot_psd(SYM, fs=64e9, nfft=256)
    for a, b in zip(_lines(ax), _lines(want)):
        np.testing.assert_allclose(a, b, rtol=1e-6)


@pytest.mark.parametrize("rule", ["MAP", "ML"])
def test_colored_const_and_decision_boundaries(rule):
    ax = tplot.plot_colored_const(cpu(SYM[:, 0]), 16, "qam", rule=rule)
    want = jplot.plot_colored_const(SYM[:, 0], 16, "qam", rule=rule)
    np.testing.assert_array_equal(ax.collections[0].get_array(),
                                  want.collections[0].get_array())
    ax = tplot.plot_decision_boundaries(16, "qam", rule=rule, grid=64)
    want = jplot.plot_decision_boundaries(16, "qam", rule=rule, grid=64)
    assert len(ax.collections) == len(want.collections) > 0


@pytest.mark.parametrize("style", ["fast", "fancy"])
def test_eyediagram(style):
    rng = np.random.default_rng(1)
    sig = np.repeat(rng.choice([-3.0, -1.0, 1.0, 3.0], size=512), 4).astype(np.float32)
    ax = tplot.eyediagram(cpu(sig), sps=4, n_traces=50, style=style)
    want = jplot.eyediagram(sig, sps=4, n_traces=50, style=style)
    for a, b in zip(_lines(ax), _lines(want)):
        np.testing.assert_array_equal(a, b)


def test_osa_matches_jax():
    ax = tplot.osa(cpu(SYM), 64e9)
    want = jplot.osa(SYM, 64e9)
    for a, b in zip(_lines(ax), _lines(want)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)


def test_animate_const_gif(tmp_path):
    pytest.importorskip("PIL")
    out = tplot.animate_const_gif([cpu(SYM[:256, 0]), cpu(SYM[256:512, 0])],
                                  str(tmp_path / "c.gif"), fps=2)
    assert (tmp_path / "c.gif").stat().st_size > 0 and out.endswith("c.gif")


def test_plot_binary_matrix():
    H = tfec.hamming_parity_check_matrix(3)
    for arg in (H, cpu(H)):
        ax = tfec.plot_binary_matrix(arg)
        want = jfec.plot_binary_matrix(jfec.hamming_parity_check_matrix(3), ax=plt.figure().gca())
        np.testing.assert_array_equal(ax.collections[0].get_offsets(),
                                      want.collections[0].get_offsets())
        assert ax.get_title() == want.get_title() == "Matrix: 3 x 7"
        plt.close("all")


def test_importing_the_port_does_not_import_matplotlib():
    code = ("import sys; import opticommpy_torch, opticommpy_torch.compat, "
            "opticommpy_torch.comm.fec; print('matplotlib' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=pathlib.Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "False"
