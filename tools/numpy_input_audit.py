"""Run ``chip_smoke.py`` with a record of every call in which a port function
sent a non-tensor input (a NumPy array, a list, a scalar) to the card.

Such an input goes through ``opticommpy_torch.utils.rng.as_device_tensor``,
which asks ``default_device()`` for the card; this script wraps
``default_device`` and notes, for each such call, the port function that
received the input and the line of ``chip_smoke.py`` that called into the
port. Functions in ``REPAIRED_NOW`` took a NumPy input to the CPU until the
device rule reached them; a line calling one of them ran that step on the
host before. Functions that followed the rule already are listed apart.

Usage (on the card; it runs the whole of ``chip_smoke.py``):
    python3 tools/numpy_input_audit.py [--out build/numpy_input_audit.json]
"""

import argparse
import collections
import json
import os
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from opticommpy_torch.utils import rng  # noqa: E402

# the entry points whose main input went to the CPU as a NumPy array until
# the device rule reached them (the kernels' entries and the receiver's
# front end among them)
REPAIRED_NOW = {
    "coherent_dsp_chain", "coherent_dsp_chain_batch", "coherent_dsp_serve", "edc",
    "_mimo_adapt_equalizer", "mimo_adapt_equalizer_batch", "mimo_apply", "mimo_apply_fused",
    "unwrap", "bps", "ddpll", "viterbi", "fourth_power_foe", "cpr", "residual_linewidth",
    "gardner_clock_recovery", "ffw_clock_recovery", "gardner_ted", "gardner_ted_nyquist",
    "interpolator", "linear_fiber_channel", "manakov_ssf", "mzm", "iqm", "pbs", "photodiode",
    "balanced_pd", "optical_hybrid_2x4", "coherent_receiver", "pdm_coherent_receiver", "edfa",
    "fir_filter", "overlap_save", "sig_pow", "signal_power", "pnorm", "anorm", "upsample",
    "clock_sampling_interp", "decimate", "resample", "finddelay", "symbol_sync",
    "moving_average", "delay_signal", "iq_mixing", "min_euclid", "demap", "modulate_gray",
    "demodulate_gray", "bert", "fast_ber_calc", "monte_carlo_gmi", "calc_llr", "calc_evm",
    "llr2bit_prob", "bps_kernel", "mimo_eq_kernel", "mimo_eq_kernel_batch",
    "mimo_rls_kernel", "mimo_rls_kernel_batch", "ddpll_kernel",
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "numpy_input_audit.json"))
    args = ap.parse_args()
    hits = collections.Counter()
    inner = rng.default_device

    def audited(device=None):
        frame = sys._getframe(1)
        if device is None and frame.f_code.co_name == "as_device_tensor":
            entry = frame.f_back.f_code.co_name
            site = [f for f in traceback.extract_stack(frame)
                    if f.filename.endswith("chip_smoke.py")]
            where = f"chip_smoke.py:{site[-1].lineno} ({site[-1].name})" if site else "?"
            hits[(entry, where)] += 1
        return inner(device)

    rng.default_device = audited
    import chip_smoke

    status = "ok"
    try:
        chip_smoke.main()
    except BaseException as exc:  # report what was seen, then fail as the run did
        status = f"chip_smoke failed: {exc!r}"[:2000]
        raise
    finally:
        rows = [dict(function=f, call_site=w, calls=n, repaired_now=f in REPAIRED_NOW)
                for (f, w), n in sorted(hits.items())]
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(dict(status=status, numpy_inputs=rows), fh, indent=1)
        print(f"numpy input audit: {len(rows)} call sites, "
              f"{sum(r['repaired_now'] for r in rows)} of them ran on the host before the "
              f"device rule reached their function; {args.out}", file=sys.stderr)
        for r in rows:
            print(f"  {r}", file=sys.stderr)


if __name__ == "__main__":
    main()
