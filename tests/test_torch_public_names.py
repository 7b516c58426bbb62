"""Every public name of the JAX package has its counterpart in the port.

An AST sweep of each module of opticommpy_tpu/ (its top-level functions,
classes and assignments, and what a package's ``__init__`` imports) against
the module of the same path in opticommpy_torch/, where the Pallas kernel
modules ``kernels/X_pallas.py`` become the Hopper kernels' ``kernels/X.py``
and their entry points ``X_pallas`` the port's ``X_kernel``. The only names
left out are the TPU plumbing ROADMAP.md lists under "Do not port TPU
plumbing".
"""

import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "opticommpy_tpu"

# kernels/<JAX module> -> kernels/<port module>
MODULES = {"bps_pallas": "bps", "ddpll_pallas": "ddpll", "dfe_pallas": "dfe",
           "gardner_pallas": "gardner", "ldpc_pallas": "ldpc", "lift_pallas": "lift",
           "mimo_pallas": "mimo_eq", "qc_pallas": "qc", "rls_pallas": "rls",
           "volterra_pallas": "volterra"}
# the Pallas entry points -> the Hopper kernels' entry points
ENTRIES = {"bps_pallas": "bps_kernel", "ddpll_pallas": "ddpll_kernel",
           "dfe_pallas": "dfe_kernel", "ffe_pallas": "ffe_kernel",
           "gardner_pallas": "gardner_kernel", "mimo_eq_pallas": "mimo_eq_kernel",
           "mimo_eq_pallas_batch": "mimo_eq_kernel_batch", "mimo_lms_pallas": "mimo_lms_kernel",
           "mimo_rls_pallas": "mimo_rls_kernel", "mimo_rls_pallas_batch": "mimo_rls_kernel_batch",
           "volterra_pallas": "volterra_kernel", "check_update_msa_pallas": "check_update_msa",
           "lift_iter_pallas": "lift_iter"}
# names the port keeps in another module: the megakernel's budget sits with
# the decoder's routing rule (comm/fec_qc.takes_megakernel)
MOVED = {("kernels/qc_mega.py", n): "opticommpy_torch.comm.fec_qc"
         for n in ("MEGA_VMEM_BUDGET", "MegaBudgetError", "mega_state_bytes")}
# TPU plumbing (ROADMAP.md, "Do not port TPU plumbing"): whole modules ...
PLUMBING_MODULES = {"kernels/_util.py", "kernels/matmul_fft.py", "utils/compile_cache.py",
                    "native/__init__.py"}
# ... and single names
PLUMBING_NAMES = {("pipelines.py", "coherent_dsp_chain_ri"), ("utils/rng.py", "ensure_key"),
                  ("utils/__init__.py", "ensure_key"),
                  ("utils/__init__.py", "enable_persistent_cache"),
                  ("kernels/qc_pallas.py", "pick_bt"), ("kernels/qc_pallas.py", "tile_batch"),
                  ("kernels/qc_pallas.py", "untile_batch"),
                  ("kernels/lift_pallas.py", "lift_budget_ok")}


def _public_names(path):
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif (isinstance(node, ast.ImportFrom) and path.name == "__init__.py"
              and node.module != "__future__"):
            names.update(a.asname or a.name for a in node.names)
    return sorted(n for n in names if not n.startswith("_"))


def _port_module(rel):
    parts = list(pathlib.PurePosixPath(rel).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(["opticommpy_torch"] + [MODULES.get(p, p) for p in parts])


CASES = [(str(p.relative_to(JAX_PKG)), name)
         for p in sorted(JAX_PKG.rglob("*.py"))
         if str(p.relative_to(JAX_PKG)) not in PLUMBING_MODULES
         for name in _public_names(p)
         if (str(p.relative_to(JAX_PKG)), name) not in PLUMBING_NAMES]


def test_the_sweep_covers_the_whole_package():
    modules = {rel for rel, _ in CASES}
    assert "parallel/sharded.py" in modules and "parallel/__init__.py" in modules
    assert len(modules) == 54 and len(CASES) == 593


@pytest.mark.parametrize("rel, name", CASES, ids=[f"{r}:{n}" for r, n in CASES])
def test_the_port_has_the_name(rel, name):
    module = importlib.import_module(MOVED.get((rel, name), _port_module(rel)))
    assert hasattr(module, ENTRIES.get(name, name)), f"{module.__name__} lacks {name}"
