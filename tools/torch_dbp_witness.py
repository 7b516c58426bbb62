"""Per-arm mean SNRs of the port's path I over several transmitters, to set
and back chip_smoke.py's SNR gate against the JAX package.

Runs chip_smoke.py's DBP link (dbp_link: five launch powers through one
manakov_ssf call, then per power an EDC arm and a manakov_dbp arm, each
through symbol_sync, the MIMO equalizer on K2 and BPS on K1) on two kinds
of transmitted field:
- the port's own simple_wdm_tx at each seed of --seeds (chip_smoke.py's
  path I uses seed 7);
- each field that tools/jax_dbp_reference.py --save-tx wrote from the JAX
  package's transmitter (--jax-tx), so that the two packages' receivers
  see the same symbols and the same field.

Usage: python tools/torch_dbp_witness.py [--seeds 7 8 9]
[--jax-tx build/dbp_tx_jax_seed7.npz ...] [--device cuda] [--n-bits N]
[--out build/dbp_witness.json]
Prints one line per run with each power's per-arm mean SNR [dB], BER and
GMI per polarization, and writes them all as one JSON object to --out.
On a CUDA device the kernels are built first; --device cpu runs the
kernels' plain versions (use a small --n-bits there).
"""

import argparse
import glob
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _summary(scores):
    out = {}
    for p_dbm, arms in scores.items():
        row = {arm: dict(snr_mean=float(np.mean(m["snr"])), snr=m["snr"].tolist(),
                         ber=m["ber"].tolist(), gmi=m["gmi"].tolist())
               for arm, m in arms.items()}
        row["dbp_gain_db"] = row["dbp"]["snr_mean"] - row["edc"]["snr_mean"]
        out[str(p_dbm)] = row
    return out


def _line(name, summ):
    return name + ": " + "; ".join(
        f"{p} dBm EDC {r['edc']['snr_mean']:.4f} DBP {r['dbp']['snr_mean']:.4f} "
        f"(gain {r['dbp_gain_db']:.4f})" for p, r in summ.items())


def main(seeds, jax_tx, device, n_bits, out_path):
    from opticommpy_torch.models.tx import simple_wdm_tx

    dev = torch.device(device)
    info = {"device": device}
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from opticommpy_torch.kernels import _build

        _build.load_library()
        info["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        print(info["card"], flush=True)
    cfg_tx = cs.dbp_tx_config(n_bits)
    runs = {}
    for seed in seeds:
        t0 = time.time()
        sig_tx, symb_tx, _ = simple_wdm_tx(torch.Generator(device=dev).manual_seed(seed),
                                           cfg_tx)
        scores = cs.dbp_link(sig_tx, symb_tx[:, :, 0], cfg_tx.Fs)[3]
        runs[f"port seed {seed}"] = summ = _summary(scores)
        print(_line(f"port tx seed {seed} ({time.time() - t0:.1f} s)", summ), flush=True)
    for path in jax_tx:
        d = np.load(path)
        t0 = time.time()
        sig_tx = torch.as_tensor(d["sig_tx"], device=dev)
        symb_ref = torch.as_tensor(d["symb_ref"], device=dev)
        scores = cs.dbp_link(sig_tx, symb_ref, cfg_tx.Fs)[3]
        runs[f"jax tx seed {int(d['seed'])}"] = summ = _summary(scores)
        print(_line(f"jax tx seed {int(d['seed'])} ({time.time() - t0:.1f} s)", summ),
              flush=True)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(dict(info, runs=runs), f, indent=1)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=[7, 8, 9])
    ap.add_argument("--jax-tx", nargs="*", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-bits", type=int, default=2**18)
    ap.add_argument("--out", default="build/dbp_witness.json")
    a = ap.parse_args()
    jax_tx = sorted(glob.glob("build/dbp_tx_jax_seed*.npz")) if a.jax_tx is None else a.jax_tx
    main(a.seeds, jax_tx, a.device, a.n_bits, a.out)
