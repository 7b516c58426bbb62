"""A run with the timed path broken underneath reads not correct: for each
fault a cell can have, the program's function is replaced for the run, the
rest of the run is as the benchmark runs it (without the look for a card),
at a small size on the CPU. One card: no exchange between chips. The link
mix, which waits for its cell, is held to the faults of its channel and
its scoring."""

import pytest
import torch


def _half(chain):
    """The batch chain on the first half of the signals; the other half's
    outputs are copies of the first's."""
    def broken(sig_b, ref_b, cfg):
        h = (sig_b.shape[0] + 1) // 2
        y, ph = chain(sig_b[:h], ref_b[:h], cfg)
        idx = torch.arange(sig_b.shape[0]) % h
        cols = torch.stack([2 * idx, 2 * idx + 1], dim=1).reshape(-1)
        return y[idx], ph[:, cols]
    return broken


def _unchanged_equalizer(x, cfg, symb_ref=None, **kw):
    return x[:, ::cfg.SpS]  # the taps' starting spike, never updated


def _altered_channel(chain):
    """The first signal's symbols come out with a carrier phase 0.3 rad off."""
    def broken(sig_b, ref_b, cfg):
        y, ph = chain(sig_b, ref_b, cfg)
        return torch.cat([y[:1] * complex(torch.exp(torch.tensor(0.3j))), y[1:]]), ph
    return broken


def _altered_gmi(gmi_calc):
    """The first polarization's GMI comes out 1e-3 bit high."""
    def broken(rx, tx, M, const_type, px=None):
        gmi, ngmi = gmi_calc(rx, tx, M, const_type, px)
        return gmi + torch.nn.functional.one_hot(torch.tensor(0), gmi.numel()) * 1e-3, ngmi
    return broken


def _no_iterations(llrs, H=None, config=None, graph=None):
    return (llrs < 0).to(torch.int8), llrs, torch.ones(llrs.shape[1], dtype=torch.int8)


def _half_decoded(decode):
    def broken(llrs, H=None, config=None, graph=None):
        h = llrs.shape[1] // 2
        bits, out, fail = decode(llrs[:, :h], H, config, graph)
        rest = _no_iterations(llrs[:, h:])
        return (torch.cat([bits, rest[0]], 1), torch.cat([out, rest[1]], 1),
                torch.cat([fail, rest[2]]))
    return broken


def _altered_bit(decode):
    def broken(llrs, H=None, config=None, graph=None):
        bits, out, fail = decode(llrs, H, config, graph)
        bits = bits.clone()
        bits[0, 0] ^= 1
        return bits, out, fail
    return broken


def faults():
    import opticommpy_torch.comm.fec as fec
    import opticommpy_torch.comm.metrics as metrics
    import opticommpy_torch.models as models
    import opticommpy_torch.pipelines as pipelines

    chain = pipelines.coherent_dsp_chain_batch
    return [
        ("wdm11.link", "state unchanged", models, "manakov_ssf", lambda e, cfg, gen=None: e),
        ("wdm11.link", "answer altered", metrics, "monte_carlo_gmi",
         _altered_gmi(metrics.monte_carlo_gmi)),
        ("wdm11.rx_sweep", "state unchanged", pipelines, "mimo_adapt_equalizer_batch",
         _unchanged_equalizer),
        ("wdm11.rx_sweep", "half the batch", pipelines, "coherent_dsp_chain_batch", _half(chain)),
        ("wdm11.rx_sweep", "answer altered", pipelines, "coherent_dsp_chain_batch",
         _altered_channel(chain)),
        ("dvbs2.decode", "state unchanged", fec, "decode_ldpc", _no_iterations),
        ("dvbs2.decode", "half the batch", fec, "decode_ldpc", _half_decoded(fec.decode_ldpc)),
        ("dvbs2.decode", "answer altered", fec, "decode_ldpc", _altered_bit(fec.decode_ldpc)),
    ]


@pytest.mark.parametrize("k", range(8))
def test_broken_path_is_not_correct(cpu_run, monkeypatch, k):
    cell, what, module, name, broken = faults()[k]
    monkeypatch.setattr(module, name, broken)
    res = cpu_run(cell)
    assert not res["correct"], (cell, what, res["checks"])
