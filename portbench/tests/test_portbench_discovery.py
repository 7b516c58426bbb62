"""A configuration, a traffic mix and a per-layer metric are found by name:
a copy of the benchmark with one of each added as files (and entries in
BENCHMARK.json) runs the new cell without an edit to any file."""

import importlib.util
import json
import os
import shutil
import sys
import time

from harness import core

DUMMY_MIX = '''
import torch


class State:
    pass


def setup(ctx):
    st = State()
    st.x = torch.ones(ctx.traffic["n"]) * ctx.cfg["scale"]
    st.i = 0
    return st


def warmup(ctx, st):
    pass


def step(ctx, st):
    with ctx.spans("work"):
        st.y = st.x * 2
    st.i += 1


def results(ctx, st, n_units, elapsed):
    return {"things_s": n_units / elapsed}


def work(ctx, st):
    return st.i, 0


def release(ctx, st):
    pass


def compare(ctx, st):
    return [("y_gap", float((st.y - 2 * st.x).abs().max())), ("spare", 1.0)]
'''

DUMMY_READER = '''
def read(ctx, state, tr, scale):
    return scale * state.i
'''


def test_new_files_are_found(tmp_path):
    shutil.copytree(core.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = tmp_path / "portbench"
    bench = core.benchmark()
    (pb / "configs" / "dummy_cfg.json").write_text(json.dumps({"name": "dummy_cfg", "scale": 3.0}))
    (pb / "traffic" / "dummy.json").write_text(json.dumps({"kind": "dummy", "n": 16,
                                                           "trace_units": 2}))
    (pb / "limits" / "dummy.cell.json").write_text(json.dumps({"y_gap": 0.0}))
    (pb / "mixes" / "dummy.py").write_text(DUMMY_MIX)
    (pb / "readers" / "dummy_units.py").write_text(DUMMY_READER)
    (pb / "layer_metrics" / "work_ms.dummy.json").write_text(json.dumps(
        {"reader": "span_ms", "args": ["work"]}))
    (pb / "layer_metrics" / "units.dummy.json").write_text(json.dumps(
        {"reader": "dummy_units", "args": [10]}))
    bench["configs"].append({"name": "dummy_cfg", "source": "none", "file":
                             "portbench/configs/dummy_cfg.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy_cfg", "traffic": "dummy",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].insert(0, {"name": "things_s", "unit": "1/s", "better": "higher",
                                   "bound": 0.1, "source": "host_clock",
                                   "workloads": ["dummy.cell"]})
    for name in ("work_ms.dummy", "units.dummy"):
        bench["per_layer"].append({"name": name, "unit": "ms", "better": "lower",
                                   "source": "host_clock", "layer": "Dummy", "moves": "things_s",
                                   "workloads": ["dummy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    saved = {k: sys.modules.pop(k) for k in [k for k in sys.modules
                                             if k in ("run", "harness") or k.startswith("harness.")
                                             or k.startswith("portbench_")]}
    sys.path.insert(0, str(pb))
    try:
        spec = importlib.util.spec_from_file_location("run", pb / "run.py")
        run = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(run)
        import torch

        for trace in (0, 1):
            res = run.execute("dummy.cell", 5, 0.05, trace, torch.device("cpu"),
                              time.perf_counter(), root=str(tmp_path))
            assert res["correct"] and res["checks"] == {"y_gap": {"value": 0.0, "limit": 0.0}}
            want = {"work_ms.dummy", "units.dummy"} if trace else {"things_s", "setup_s"}
            assert set(res["metrics"]) == want
            if trace:
                assert res["metrics"]["units.dummy"]["value"] >= 10
    finally:
        sys.path.remove(str(pb))
        for k in [k for k in sys.modules if k in ("run", "harness") or k.startswith("harness.")
                  or k.startswith("portbench_")]:
            del sys.modules[k]
        sys.modules.update(saved)


def test_every_named_file_exists():
    bench = core.benchmark()
    names = {m["name"] for m in bench["end_to_end"]}
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(core.ROOT, c["file"]))
        ref = core.config(c["name"]).get("reference", c["name"])
        assert os.path.exists(os.path.join(core.HERE, "reference", ref + ".py"))
    for w in bench["workloads"]:
        assert core.limits(w["name"])
        trf = core.traffic(w["traffic"])
        assert os.path.exists(os.path.join(core.HERE, "mixes", trf["kind"] + ".py"))
        assert core.e2e_metrics(bench, w["name"]) and core.layer_metrics(bench, w["name"])
    for m in bench["per_layer"]:
        assert m["moves"] in names
        assert callable(core.reader(m["name"]))
