"""The benchmark's machinery: what a cell is made of, found by name.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix:

- ``configs/<config>.json``: the deployment's sizes and settings;
- ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names the
  generator, ``mixes/<kind>.py``, that reads it;
- ``limits/<cell>.json``: the limit of each compared number of the cell
  that decides ``correct``;
- ``layer_metrics/<metric>.json``: the per-layer metric's reader,
  ``readers/<reader>.py`` with ``read(ctx, state, tr, *args)`` returning a
  number or None, and the reader's ``args``;
- ``reference/<config>.py``: the plain reference of the configuration
  (or of the one its ``reference`` key names).

Nothing here imports the program under test.
"""

import ast
import contextlib
import hashlib
import importlib.util
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # portbench/
ROOT = os.path.dirname(HERE)  # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "opticommpy_tpu")
PROGRAM = "opticommpy_torch"


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(root, "BENCHMARK.json")


def cell(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name):
    return load_json(HERE, "configs", f"{name}.json")


def traffic(name):
    return load_json(HERE, "traffic", f"{name}.json")


def _load(path, modname):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def mix(kind):
    return _load(os.path.join(HERE, "mixes", f"{kind}.py"), f"portbench_mix_{kind}")


def reference(name):
    return _load(os.path.join(HERE, "reference", f"{name}.py"), f"portbench_reference_{name}")


def limits(cell_name):
    return load_json(HERE, "limits", f"{cell_name}.json")


def reader(metric):
    """``read(ctx, state, tr)`` of a per-layer metric: the shared reader
    that ``layer_metrics/<metric>.json`` names, with its arguments."""
    spec = load_json(HERE, "layer_metrics", f"{metric}.json")
    mod = _load(os.path.join(HERE, "readers", f"{spec['reader']}.py"),
                f"portbench_reader_{spec['reader']}")
    args = spec.get("args", [])
    return lambda ctx, state, tr: mod.read(ctx, state, tr, *args)


def counts(name):
    return _load(os.path.join(HERE, "counts", f"{name}.py"), f"portbench_counts_{name}")


def e2e_metrics(bench, cell_name):
    """The cell's end-to-end metrics: those listing it, or listing no cells."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def layer_metrics(bench, cell_name):
    """The cell's per-layer metrics: those listing it; without a list,
    those whose end-to-end metric the cell reports."""
    mine = {m["name"] for m in e2e_metrics(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in mine)]


def sub_seed(seed, *keys):
    """A 63-bit seed for one named stream of a run's seed."""
    h = hashlib.sha256(repr((int(seed),) + tuple(keys)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def forbidden_modules():
    """Loaded modules whose top-level name is, whole, one of FORBIDDEN."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def reference_imports(directory=None):
    """(file, module) pairs of every import in the reference's sources whose
    top-level name is the program's or a forbidden one."""
    directory = directory or os.path.join(HERE, "reference")
    bad = []
    for fn in sorted(os.listdir(directory)):
        if not fn.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(directory, fn)).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            for n in names:
                if n.split(".")[0] in FORBIDDEN + (PROGRAM,):
                    bad.append((fn, n))
    return bad


class Spans:
    """Host-clock spans around the calls into each layer.

    ``mode`` 'off': nothing is recorded (the measured run); 'sync': the
    device is synchronized at each boundary and the duration kept (the
    traced run's window); 'profile': a profiler range ``pb.<name>`` only.
    """

    def __init__(self):
        self.mode = "off"
        self.sync = lambda: None
        self.times = {}

    @contextlib.contextmanager
    def __call__(self, name):
        if self.mode == "off":
            yield
        elif self.mode == "sync":
            self.sync()
            t0 = time.perf_counter()
            yield
            self.sync()
            self.times.setdefault(name, []).append(time.perf_counter() - t0)
        else:
            from torch.profiler import record_function

            with record_function("pb." + name):
                yield


class Ctx:
    """What a mix, a reference and a reader are given."""

    def __init__(self, cell_name, cfg, trf, seed, device):
        self.cell = cell_name
        self.cfg = cfg
        self.traffic = trf
        self.seed = int(seed)
        self.device = device
        self.spans = Spans()
        self.notes = {}

    def seed_for(self, *keys):
        return sub_seed(self.seed, *keys)


def checks_table(numbers, held):
    """A mix's compared numbers [(name, value)] against the cell's limits
    ``held``: (all held numbers within their limits, {name: {value, limit}}
    of the held ones, {name: value} of the others). A number the cell gives
    no limit is printed and not held: its control did not separate it from
    sound runs (PERF.md)."""
    table, unheld = {}, {}
    for name, value in numbers:
        if name in held:
            table[name] = {"value": float(value), "limit": float(held[name])}
        else:
            unheld[name] = float(value)
    ok = bool(table) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                             for c in table.values())
    return ok, table, unheld
