"""The port's checkpoint and profiling helpers (opticommpy_torch.utils
.checkpoint, .profiling): files cross between the two packages both ways,
StageTimer accumulates and synchronizes, trace writes a Chrome trace."""

import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.utils import checkpoint as jck  # noqa: E402
from opticommpy_torch.utils import checkpoint as tck  # noqa: E402
from opticommpy_torch.utils import profiling as tprof  # noqa: E402

from _torch_parity import cpu, to_np  # noqa: E402


def _leaves():
    rng = np.random.default_rng(0)
    return [
        (rng.normal(size=(4, 2)) + 1j * rng.normal(size=(4, 2))).astype(np.complex64),
        rng.normal(size=(3, 3)).astype(np.float32),
        np.arange(5, dtype=np.int32),
        np.array([2.5, -1.0]),  # float64: JAX loads it as float32
    ]


def test_flat_list_from_the_port_loads_in_jax(tmp_path):
    leaves = _leaves()
    path = tck.save_state(str(tmp_path / "port.npz"), [cpu(a) for a in leaves])
    back = jck.load_state(path)
    assert len(back) == len(leaves)
    for got, want in zip(back, leaves):
        # JAX keeps 32-bit types unless x64 is on: float64 comes back float32
        assert np.asarray(got).dtype == (np.float32 if want.dtype == np.float64 else want.dtype)
        np.testing.assert_array_equal(np.asarray(got), want.astype(np.asarray(got).dtype))


def test_flat_list_from_jax_loads_in_the_port(tmp_path):
    leaves = _leaves()
    path = jck.save_state(str(tmp_path / "jax.npz"), leaves)
    back = tck.load_state(path, device="cpu")
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in back)
    for got, want in zip(back, leaves):
        assert to_np(got).dtype == want.dtype
        np.testing.assert_array_equal(to_np(got), want)


def test_nested_state_round_trips_and_matches_jax_layout(tmp_path):
    """Dicts (keys sorted), lists, tuples and None flatten in the JAX
    package's order and carry its structure text; ``like`` restores the
    nest."""
    a, b, c, d = _leaves()
    tree = {"taps": (cpu(a), cpu(b)), "cfg": {"mu": cpu(d), "skip": None}, "ids": [cpu(c)]}
    jtree = {"taps": (a, b), "cfg": {"mu": d, "skip": None}, "ids": [c]}
    p_port = tck.save_state(str(tmp_path / "sub" / "nest.npz"), tree)
    p_jax = jck.save_state(str(tmp_path / "nest_jax.npz"), jtree)
    with np.load(p_port) as fp, np.load(p_jax) as fj:
        assert sorted(fp.files) == sorted(fj.files)
        assert bytes(fp["__treedef__"]) == bytes(fj["__treedef__"])
        for k in fj.files:
            np.testing.assert_array_equal(fp[k], fj[k])
    back = tck.load_state(p_jax, like=tree, device="cpu")
    assert back.keys() == tree.keys() and isinstance(back["taps"], tuple)
    assert back["cfg"]["skip"] is None and isinstance(back["ids"], list)
    assert torch.equal(back["taps"][0], tree["taps"][0])
    assert json.loads(bytes(np.load(p_port)["__treedef__"]).decode()).startswith("PyTreeDef(")


def test_stage_timer_accumulates_and_syncs():
    timer = tprof.StageTimer()
    x = torch.ones(8)
    for _ in range(2):
        with timer("a"):
            assert timer.sync({"x": [x, (x,)]})["x"][0] is x
    with timer("b"):
        pass
    assert set(timer.times) == {"a", "b"} and timer.times["a"] >= 0.0
    table = timer.table()
    assert table.splitlines()[0].split()[:3] == ["stage", "time", "[s]"]
    assert "total" in table.splitlines()[-1]


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "tr")) as log_dir:
        torch.fft.fft(torch.ones(1024, dtype=torch.complex64))
    path = os.path.join(log_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("fft" in str(ev.get("name", "")) for ev in events)


def test_load_state_follows_the_device_rule(tmp_path):
    path = tck.save_state(str(tmp_path / "s.npz"), [cpu(np.ones(3))])
    if torch.cuda.is_available():
        assert tck.load_state(path)[0].is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tck.load_state(path)
