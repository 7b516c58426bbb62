"""The port's reference-name surface (opticommpy_torch.compat): every
public name of the JAX package's compat module exists, and deterministic
calls agree with the JAX package's compat on the same seeded NumPy inputs
(CPU tensors; tolerances stated per call)."""

import ast
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu import compat as jc  # noqa: E402
from opticommpy_torch import compat as tc  # noqa: E402

from _torch_parity import cpu, mixed_polmux, rel_err, to_np  # noqa: E402

JAX_COMPAT = pathlib.Path(__file__).resolve().parents[1] / "opticommpy_tpu" / "compat.py"


def _public_names(path):
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            names.add(node.name)
        if isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name) and not t.id.startswith("_"))
    return sorted(names)


NAMES = _public_names(JAX_COMPAT)


def test_the_jax_compat_has_its_178_names():
    assert len(NAMES) == 178


@pytest.mark.parametrize("name", NAMES)
def test_name_exists_in_the_port(name):
    assert callable(getattr(tc, name)) or isinstance(getattr(tc, name), type)


def _param(**kw):
    p = tc.parameters()
    for k, v in kw.items():
        setattr(p, k, v)
    return p


SIG, SYM = mixed_polmux(3, 512)


def _close(got, want, rel):
    if isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            _close(g, w, rel)
        return
    w = np.asarray(want)
    if np.issubdtype(w.dtype, np.integer) or w.dtype == bool or not np.any(w):
        np.testing.assert_array_equal(to_np(got), w)
    else:
        assert rel_err(got, w) <= rel


CALLS = {
    # (port call, JAX call, relative tolerance)
    "grayMapping": (lambda: tc.grayMapping(16, "qam"), lambda: jc.grayMapping(16, "qam"), 0.0),
    "pnorm": (lambda: tc.pnorm(cpu(SIG)), lambda: jc.pnorm(SIG), 1e-6),
    "firFilter": (lambda: tc.firFilter(cpu(np.array([0.2, 1.0, 0.2], np.float32)), cpu(SIG)),
                  lambda: jc.firFilter(np.array([0.2, 1.0, 0.2], np.float32), SIG), 1e-6),
    "rrcFilterTaps": (lambda: tc.rrcFilterTaps(np.arange(-8, 9) / 4, 0.1, 1.0),
                      lambda: jc.rrcFilterTaps(np.arange(-8, 9) / 4, 0.1, 1.0), 1e-6),
    "decimate": (lambda: tc.decimate(cpu(SIG), _param(SpSin=2, SpSout=1)),
                 lambda: jc.decimate(SIG, _param(SpSin=2, SpSout=1)), 0.0),
    "edc": (lambda: tc.edc(cpu(SIG), _param(L=20, D=16, Fs=64e9, Rs=32e9)),
            lambda: jc.edc(SIG, _param(L=20, D=16, Fs=64e9, Rs=32e9)), 1e-5),
    "fastBERcalc": (lambda: tc.fastBERcalc(cpu(SIG[::2]), cpu(SYM), 16, "qam"),
                    lambda: jc.fastBERcalc(SIG[::2], SYM, 16, "qam"), 1e-5),
    "hermit": (lambda: tc.hermit(cpu(SYM[:8, 0])), lambda: jc.hermit(SYM[:8, 0]), 0.0),
    "modulateOFDM": (lambda: tc.modulateOFDM(cpu(SYM[:, 0]), _param(Nfft=64, G=8, SpS=1)),
                     lambda: jc.modulateOFDM(SYM[:, 0], _param(Nfft=64, G=8, SpS=1)), 1e-5),
    "calcPertCoeffMatrix": (lambda: tc.calcPertCoeffMatrix(_param(matrixOrder=5)),
                            lambda: jc.calcPertCoeffMatrix(_param(matrixOrder=5)), 0.0),
    "perturbationNLIN": (lambda: tc.perturbationNLIN(cpu(SYM), _param(matrixOrder=5, Pin=2.0)),
                         lambda: jc.perturbationNLIN(SYM, _param(matrixOrder=5, Pin=2.0)), 2e-6),
    "calcNLINperturbation": (
        lambda: tc.calcNLINperturbation(*tc.calcPertCoeffMatrix(_param(matrixOrder=5))[1:],
                                        cpu(SYM[:, 0]), cpu(SYM[:, 1])),
        lambda: jc.calcNLINperturbation(*jc.calcPertCoeffMatrix(_param(matrixOrder=5))[1:],
                                        SYM[:, 0], SYM[:, 1]), 2e-6),
    "edfParams": (lambda: tc.edfParams(tc.edfaArgs(_param(type="none")))["absCoef"],
                  lambda: jc.edfParams(jc.edfaArgs(_param(type="none")))["absCoef"], 0.0),
    "encoder": (lambda: tc.encoder(np.eye(3, 7, dtype=np.uint8), np.ones((3, 2))),
                lambda: jc.encoder(np.eye(3, 7, dtype=np.uint8), np.ones((3, 2))), 0.0),
    "minR": (lambda: tc.minR(np.array([0.1, 0.5, 0.9]), 0.6),
             lambda: jc.minR(np.array([0.1, 0.5, 0.9]), 0.6), 0.0),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_deterministic_call_matches_jax(name):
    port, jax_call, rel = CALLS[name]
    _close(port(), jax_call(), rel)


def test_check_gpu_and_seeds_follow_the_device():
    assert tc.checkGPU() == torch.cuda.is_available()
    g = tc._key(3, cpu(SIG))
    assert isinstance(g, torch.Generator) and g.device.type == "cpu"
    out = tc.awgn(cpu(SIG), _param(snr=20.0, seed=5))
    assert out.device.type == "cpu" and torch.equal(out, tc.awgn(cpu(SIG), _param(snr=20.0,
                                                                                 seed=5)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tc.gaussianNoise((8,), 1.0, seed=1)
