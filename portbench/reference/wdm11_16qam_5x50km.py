"""Plain reference of the 11-channel coherent WDM link and its receiver.

Plain PyTorch (the link, on any device) and NumPy (the equalizer's
per-symbol recurrence, on the host). It imports nothing of the program
under test: it follows the published description of each stage, which the
port implements too:

- Tx: Gray 16-QAM symbols, upsampling, root-raised-cosine shaping, an IQ
  modulator of two Mach-Zehnder arms (Vpi 2, bias -2, 60 dB extinction),
  the Tx laser's phase noise, launch power per channel, frequency shift
  onto the WDM grid;
- fibre: the Manakov equation by the symmetric split step with the
  linear half-steps merged, the nonlinear step anchored on the start
  power, (8/9) gamma; per span a lumped EDFA of gain alpha*Lspan and ASE
  of (G-1) nsp h Fc over the simulation bandwidth;
- receiver: a local oscillator with random-walk phase noise and a
  frequency offset, a 90-degree hybrid per polarization and ideal
  balanced photodiodes;
- DSP: matched filter, decimation at the largest-variance phase, CD
  compensation, power normalization, fourth-power FOE, the 2x2 MIMO
  equalizer (da-rde twice over the training symbols, then dd-lms),
  blind phase search over a sliding window and phase unwrapping;
- scoring: BER, GMI and SNR per polarization as OptiCommPy defines them.

``rnd`` rounds every stored intermediate: the identity for the reference,
:func:`bf16` for the control, the reference computed in bfloat16 (the next
precision below the float32 that the configuration states).
"""

import math

import numpy as np
import torch

C_LIGHT = 299792458.0
H_PLANCK = 6.62607015e-34
# The carrier phase ramps 2 pi f t (WDM grid, LO offset) reach 2.4e6 rad
# over a record; they are computed in float64, as OptiCommPy computes them.
# ``witness_phase.py`` sets float32 to show what float32 ramps cost.
PHASE_DTYPE = torch.float64


def ident(x):
    return x


def bf16(x):
    """Round a float32 or complex64 tensor to bfloat16 and back."""
    if x.is_complex():
        return torch.complex(x.real.to(torch.bfloat16).float(), x.imag.to(torch.bfloat16).float())
    return x.to(torch.bfloat16).to(x.dtype)


def bf16_np(a):
    """Round a float32 / complex64 NumPy array to bfloat16 (nearest, ties to even)."""
    f = np.ascontiguousarray(a).view(np.float32)
    u = f.view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return u.view(np.float32).view(a.dtype).reshape(a.shape)


# ---------------------------------------------------------------------------
# constellation and bit labels
# ---------------------------------------------------------------------------

def qam16_gray():
    """16-QAM points indexed by their Gray label (MSB first), unit mean energy."""
    lev = np.arange(-3, 4, 2)
    grid = np.tile(lev, (4, 1))
    const = grid + 1j * np.flipud(grid.T)
    for row in (1, 3):  # serpentine rows: the natural order is a Gray walk
        const[row] = const[row][::-1]
    natural = const.reshape(-1)
    gray = np.arange(16) ^ (np.arange(16) >> 1)
    out = natural[np.argsort(gray)]
    return (out / np.sqrt(np.mean(np.abs(out) ** 2))).astype(np.complex64)


def bit_labels(m=16):
    b = int(np.log2(m))
    return ((np.arange(m)[:, None] >> np.arange(b - 1, -1, -1)[None, :]) & 1).astype(np.int64)


# ---------------------------------------------------------------------------
# link
# ---------------------------------------------------------------------------

def rrc_taps(sps, n_taps, rolloff):
    """Root-raised-cosine taps on OptiCommPy's grid, normalized to unit sum."""
    t = np.linspace(-(n_taps // 2), n_taps // 2, n_taps) / sps
    a = rolloff
    eps = 1e-9
    with np.errstate(divide="ignore", invalid="ignore"):
        num = np.sin(np.pi * t * (1 - a)) + 4 * a * t * np.cos(np.pi * t * (1 + a))
        h = num / (np.pi * t * (1 - (4 * a * t) ** 2))
    h = np.where(np.abs(t) < eps, 1 + a * (4 / np.pi - 1), h)
    t_sing = 1 / (4 * a)
    h_sing = a / np.sqrt(2) * ((1 + 2 / np.pi) * np.sin(np.pi / (4 * a))
                               + (1 - 2 / np.pi) * np.cos(np.pi / (4 * a)))
    h = np.where(np.abs(np.abs(t) - t_sing) < eps, h_sing, h)
    return h / np.sum(h)


def fir_same(h, x, rnd=ident):
    """'same' linear convolution along dim 0 of (N, C) ``x`` by FFT."""
    n, k = x.shape[0], h.shape[0]
    nfft = 1 << int(math.ceil(math.log2(n + k - 1)))
    hf = torch.fft.fft(torch.as_tensor(h, dtype=torch.complex64, device=x.device), n=nfft)
    y = rnd(torch.fft.ifft(rnd(torch.fft.fft(x.to(torch.complex64), n=nfft, dim=0)) * hf[:, None],
                           dim=0))
    s = (k - 1) // 2
    return y[s:s + n]


def wdm_grid(n_ch, spacing):
    g = np.arange(-np.floor(n_ch / 2), np.floor(n_ch / 2) + 1) * spacing
    if n_ch % 2 == 0:
        g = g[:n_ch] + spacing / 2
    return g[:n_ch]


def mzm(e, u, vpi=2.0, vb=-2.0, er_db=60.0):
    er = 10 ** (er_db / 10)
    g = 2 * math.sqrt(er) / (er + 1)
    ph = (u + vb) / 2 / vpi * math.pi
    return (math.sqrt(1 + g) * (e / 2) * torch.exp(1j * ph)
            + math.sqrt(1 - g) * (e / 2) * torch.exp(-1j * ph))


def tx(symbols, pn, tx_cfg, rnd=ident):
    """The WDM field (N, 2) from symbols (nCh, 2, nSym) and the Tx lasers'
    phase noise (nCh, N)."""
    n_ch, n_pol, n_sym = symbols.shape
    sps = tx_cfg["SpS"]
    fs = tx_cfg["Rs"] * sps
    n = n_sym * sps
    dev = symbols.device
    cols = symbols.reshape(n_ch * n_pol, n_sym).T
    up = torch.zeros((n_sym, sps, n_ch * n_pol), dtype=torch.complex64, device=dev)
    up[:, 0] = cols
    h = rrc_taps(sps, tx_cfg["nFilterTaps"], tx_cfg["pulseRollOff"])
    sig = fir_same(h, up.reshape(n, n_ch * n_pol), rnd)
    sig = sig / torch.amax(torch.abs(sig), dim=0, keepdim=True)
    sig = sig.T.reshape(n_ch, n_pol, n)
    carrier = torch.exp(1j * pn)[:, None, :] / math.sqrt(2)
    u = 0.5 * sig  # mzmScale
    e = mzm(carrier, u.real) + 1j * mzm(carrier, u.imag)
    e = rnd(e)
    e = e / torch.sqrt((e * e.conj()).real.mean(dim=-1, keepdim=True))
    p_w = 10 ** (tx_cfg["powerPerChannel_dBm"] / 10) * 1e-3
    e = e * math.sqrt(p_w / n_pol)
    t = torch.arange(n, dtype=PHASE_DTYPE, device=dev) / fs
    fg = torch.as_tensor(wdm_grid(n_ch, tx_cfg["wdmGridSpacing"]), dtype=PHASE_DTYPE, device=dev)
    shift = torch.exp(1j * ((2 * math.pi * fg)[:, None] * t[None, :])).to(torch.complex64)
    return rnd(torch.sum(e * shift[:, None, :], dim=0).T)


def fiber_consts(fib):
    lam = C_LIGHT / 1e3 / fib["Fc"]
    alpha = fib["alpha"] / (10 * np.log10(np.e))
    beta2 = -(fib["D"] * lam ** 2) / (2 * np.pi * C_LIGHT / 1e3)
    return alpha, beta2


def manakov(e_in, fib, fs, gen, rnd=ident):
    """The (N, 2) field through ``Ltotal / Lspan`` spans, each followed by
    its EDFA, with ASE drawn from ``gen``."""
    alpha, beta2 = fiber_consts(fib)
    n = e_in.shape[0]
    dev = e_in.device
    hz = fib["hz"]
    n_steps = int(round(fib["Lspan"] / hz))
    w = 2 * np.pi * fs * torch.fft.fftfreq(n, d=1.0, device=dev, dtype=torch.float64)
    lin = torch.complex(torch.full_like(w, -alpha / 2), beta2 / 2 * w * w)
    half = torch.exp(lin * (hz / 2)).to(torch.complex64)
    full = torch.exp(lin * hz).to(torch.complex64)
    g_db, nf = fib["alpha"] * fib["Lspan"], 10 ** (fib["NF"] / 10)
    g = 10 ** (g_db / 10)
    nsp = (g * nf - 1) / (2 * (g - 1))
    p_ase = (g - 1) * nsp * H_PLANCK * fib["Fc"] * fs
    k_nl = (8 / 9) * fib["gamma"] * hz
    e = e_in.T.contiguous().to(torch.complex64)  # (2, N)
    for _ in range(int(fib["Ltotal"] // fib["Lspan"])):
        ef = rnd(torch.fft.fft(e, dim=-1) * half)
        for s in range(n_steps):
            et = rnd(torch.fft.ifft(ef, dim=-1))
            p = (et * et.conj()).real.sum(dim=0)
            et = rnd(et * torch.exp(1j * (k_nl * p)))
            ef = rnd(torch.fft.fft(et, dim=-1) * (full if s < n_steps - 1 else half))
        e = torch.fft.ifft(ef, dim=-1) * math.sqrt(g)
        std = math.sqrt(p_ase / 2)
        e = rnd(e + torch.complex(std * torch.randn(e.shape, generator=gen, device=dev),
                                  std * torch.randn(e.shape, generator=gen, device=dev)))
    return e.T


def laser(p_dbm, lw, n, fs, f_shift, gen):
    dev = gen.device
    std = math.sqrt(2 * math.pi * lw / fs)
    pn = torch.cat([torch.zeros(1, device=dev, dtype=torch.float64),
                    torch.cumsum(std * torch.randn(n - 1, generator=gen, device=dev,
                                                   dtype=torch.float64), 0)])
    k = torch.arange(n, device=dev, dtype=PHASE_DTYPE)
    ph = 2 * math.pi * f_shift * k / fs + pn.to(PHASE_DTYPE)
    return (math.sqrt(10 ** (p_dbm / 10) * 1e-3) * torch.exp(1j * ph)).to(torch.complex64)


def pdm_receiver(e_s, lo, rnd=ident):
    """90-degree hybrids and ideal balanced photodiodes per polarization,
    the LO split at 45 degrees: (N, 2) complex photocurrents."""
    los = (lo * math.cos(math.pi / 4), -lo * math.sin(math.pi / 4))
    out = []
    for p in range(2):
        s, l = e_s[:, p], los[p]
        o0, o1 = 0.5 * s - 0.5 * l, 0.5j * s + 0.5j * l
        o2, o3 = 0.5j * s - 0.5 * l, -0.5 * s + 0.5j * l
        pw = [(o * o.conj()).real for o in (o0, o1, o2, o3)]
        out.append(torch.complex(pw[1] - pw[0], pw[2] - pw[3]))
    return rnd(torch.stack(out, dim=1))


def receive_all(sig_ch, symbols, cfg, gen, rnd=ident):
    """Every channel through its own LO (grid + offset) and front end:
    (signals (B, N, 2), symbols aligned to each received signal (B, nSym, 2))."""
    txc, lo_c = cfg["tx"], cfg["lo"]
    fs = txc["Rs"] * txc["SpS"]
    grid = wdm_grid(txc["nChannels"], txc["wdmGridSpacing"])
    sigs, refs = [], []
    for k, f_k in enumerate(grid):
        lo = laser(lo_c["P_dBm"], lo_c["lw"], sig_ch.shape[0], fs, float(f_k) + lo_c["freqOffset"],
                   gen)
        rx = pdm_receiver(sig_ch, lo, rnd)
        sigs.append(rx)
        refs.append(align_symbols(rx, symbols[k].T, cfg))
    return torch.stack(sigs), torch.stack(refs)


def full_rate(rx, cfg):
    """A received (N, 2) signal matched-filtered and CD-compensated at the
    simulation rate (``SpS`` samples per symbol)."""
    txc, rxc = cfg["tx"], cfg["rx"]
    x = fir_same(rrc_taps(txc["SpS"], txc["nFilterTaps"], txc["pulseRollOff"]), rx)
    return cd_comp(x, rxc["L"], rxc["D"], cfg["fiber"]["Fc"], txc["SpS"] * txc["Rs"], txc["Rs"])


def align_symbols(rx, sym, cfg):
    """The transmitted symbols (nSym, 2), each polarization rolled to the
    delay at which its amplitudes correlate best with the received signal's
    at the sampling phase (of four) of the strongest correlation."""
    sps = cfg["tx"]["SpS"]
    x16 = full_rate(rx, cfg)
    n = sym.shape[0]
    cols = []
    for p in range(sym.shape[1]):
        best = max((best_lag(x16[ph::sps][:n, p], sym[:, p], peak=True)
                    for ph in range(0, sps, max(1, sps // 4))), key=lambda lp: lp[1])
        cols.append(torch.roll(sym[:, p], best[0]))
    return torch.stack(cols, dim=1)


def da_snr(rx, sym, cfg, block=32):
    """Data-aided SNR (dB) per polarization of a received (N, 2) signal
    against its aligned symbols (nSym, 2): at each of the ``SpS`` sampling
    phases of the matched-filtered, CD-compensated signal, the carrier
    frequency removed (the lag-one product of ``x conj(s)``) and a complex
    gain fitted by least squares to each block of ``block`` symbols; the
    fitted signal's power over the residual's, at the best phase. No
    decision is taken, so the number follows the channel and not the DSP."""
    sps = cfg["tx"]["SpS"]
    x16 = full_rate(rx, cfg)
    n = sym.shape[0]
    nb = n // block
    k = torch.arange(n, device=rx.device, dtype=torch.float64)
    out = []
    for p in range(sym.shape[1]):
        s = sym[:, p]
        sb = s[:nb * block].reshape(nb, block)
        best = -math.inf
        for ph in range(sps):
            x = x16[ph::sps][:n, p]
            z = x * s.conj()
            f = float(torch.angle(torch.sum(z[1:] * z[:-1].conj())))
            xb = (x * torch.exp(-1j * f * k).to(torch.complex64))[:nb * block].reshape(nb, block)
            g = (xb * sb.conj()).sum(dim=1) / (torch.abs(sb) ** 2).sum(dim=1)
            fit = g[:, None] * sb
            best = max(best, float(10 * torch.log10(torch.sum(torch.abs(fit) ** 2)
                                                   / torch.sum(torch.abs(xb - fit) ** 2))))
        out.append(best)
    return torch.tensor(out)


def best_lag(x, s, peak=False):
    """The circular lag d that maximises the correlation of the centered
    amplitudes, sum_n a_x[n] a_s[n - d] (unchanged by phase and frequency
    offsets); with ``peak`` also the correlation there."""
    a = torch.abs(x) - torch.abs(x).mean()
    b = torch.abs(s) - torch.abs(s).mean()
    c = torch.abs(torch.fft.ifft(torch.fft.fft(a.to(torch.complex64))
                                 * torch.fft.fft(b.to(torch.complex64)).conj()))
    d = int(torch.argmax(c))
    return (d, float(c[d])) if peak else d


def link(symbols, pn, cfg, gen, rnd=ident):
    """The whole link for one realization: received signals and aligned symbols."""
    txc = cfg["tx"]
    fs = txc["Rs"] * txc["SpS"]
    sig = tx(symbols, pn, txc, rnd)
    sig = manakov(sig, cfg["fiber"], fs, gen, rnd)
    return receive_all(sig, symbols, cfg, gen, rnd)


# ---------------------------------------------------------------------------
# receiver DSP
# ---------------------------------------------------------------------------

def decimate(x, sps_in, sps_out):
    n, m = x.shape
    n_sym = n // sps_in
    blocks = x[:n_sym * sps_in].reshape(n_sym, sps_in, m)
    c = blocks - blocks.mean(dim=0, keepdim=True)
    d = torch.argmax((c * c.conj()).real.mean(dim=0), dim=0)
    cols = [torch.roll(x[:, j], -int(d[j])) for j in range(m)]
    return torch.stack(cols, dim=1)[::sps_in // sps_out]


def cd_comp(x, L, D, fc, fs, rs, rnd=ident):
    """CD compensation by the inverse fibre response on Savory's tap count,
    applied as one FFT convolution (delay-compensated)."""
    lam = C_LIGHT / 1e3 / fc
    beta2 = -(D * lam ** 2) / (2 * np.pi * C_LIGHT / 1e3)
    n_c = int(2 * np.ceil(6.67 * abs(beta2) * L * rs ** 2 * (fs / rs)))
    w = 2 * np.pi * fs * np.fft.fftfreq(n_c)
    h = np.fft.fftshift(np.fft.ifft(np.exp(-1j * (beta2 / 2) * w ** 2 * L)))
    n = x.shape[0]
    big = 1 << int(np.ceil(np.log2(n + n_c)))
    hf = torch.as_tensor(np.fft.fft(h, big).astype(np.complex64), device=x.device)
    y = rnd(torch.fft.ifft(rnd(torch.fft.fft(x, n=big, dim=0)) * hf[:, None], dim=0))
    return y[n_c // 2:n_c // 2 + n]


def pnorm(x):
    return x / torch.sqrt(torch.mean((x * x.conj()).real))


def foe4(x, fs):
    """Fourth-power frequency estimate and removal; the grid, the estimate
    and the phase ramp in float32, as OptiCommPy computes them."""
    n = x.shape[0]
    x2 = x * x
    spec = torch.abs(torch.fft.fft(x2 * x2, dim=0))
    k = torch.cat([torch.arange(0, (n - 1) // 2 + 1, device=x.device),
                   torch.arange(-(n // 2), 0, device=x.device)]).to(torch.float32)
    f = k / torch.tensor(float(n), device=x.device) * fs
    fo = f[torch.argmax(spec, dim=0)] / 4
    t = torch.arange(n, dtype=torch.float32, device=x.device)[:, None] / fs
    return x * torch.exp(1j * ((-2 * math.pi * fo)[None, :] * t))


def front_end(sig, cfg, rnd=ident):
    txc, rxc = cfg["tx"], cfg["rx"]
    rs, sps_in = txc["Rs"], rxc["SpS_in"]
    fs = rs * 2
    x = fir_same(rrc_taps(sps_in, txc["nFilterTaps"], txc["pulseRollOff"]), sig, rnd)
    x = decimate(x, sps_in, 2)
    x = pnorm(cd_comp(x, rxc["L"], rxc["D"], cfg["fiber"]["Fc"], fs, rs, rnd))
    return rnd(pnorm(foe4(x, fs)))


def equalize(x, ref, cfg, rnd_np=None):
    """The 2x2 MIMO equalizer on B signals at 2 samples per symbol, as
    OptiCommPy's mimoAdaptEqualizer defines it: taps H[out, in, tap] from
    a centre spike; ``out = sum(H * window)``; da-rde (err = |ref|^2 -
    |out|^2, H += mu err out conj(window)) over nTrain symbols, twice;
    then dd-lms (err = decision - out, H += mu err conj(window)) over the
    rest. The recurrence runs on the host in NumPy, float32.
    x: (B, 2 nSym, 2) complex64 NumPy; ref: (B, nSym, 2). Returns (B, nSym, 2)."""
    rxc = cfg["rx"]
    nt, sps = rxc["nTaps"], 2
    mu_a, mu_b = (np.float32(m) for m in rxc["mu"])
    n_train = rxc["nTrain"]
    b, n_s, m = x.shape
    n_sym = ref.shape[1]
    lp = nt // 2
    pad = np.zeros((b, lp + n_s + lp + sps + nt, m), np.complex64)
    pad[:, lp:lp + n_s] = x
    # the window of symbol i: rows i*sps .. i*sps + nt - 1, flattened (in, tap)
    win_all = np.lib.stride_tricks.sliding_window_view(pad, nt, axis=1)  # (B, rows, m, nt)
    const = qam16_gray()
    h = np.zeros((b, m, m, nt), np.complex64)
    h[:, np.arange(m), np.arange(m), lp] = 1.0
    h = h.reshape(b, m, m * nt)
    y = np.empty((b, n_sym, m), np.complex64)
    r2 = (np.abs(ref) ** 2).astype(np.float32)
    q = rnd_np if rnd_np is not None else (lambda a: a)
    for start, length, rule, mu, passes in ((0, n_train, "da-rde", mu_a, 2),
                                            (n_train, n_sym - n_train, "dd-lms", mu_b, 1)):
        for _ in range(passes):
            for i in range(start, start + length):
                w = win_all[:, i * sps].reshape(b, m * nt)
                out = q((h * w[:, None, :]).sum(axis=-1))
                if rule == "da-rde":
                    e = q((r2[:, i] - (out.real ** 2 + out.imag ** 2)).astype(np.float32) * out)
                else:
                    dec = const[np.argmin(np.abs(out[..., None] - const) ** 2, axis=-1)]
                    e = q(dec - out)
                h = q(h + mu * e[:, :, None] * w.conj()[:, None, :])
                y[:, i] = out
    return y


def bps(y, n_half, n_phases, rnd=ident, chunk=4):
    """Blind phase search on (N, C) columns: per test phase in [0, pi/2) the
    smallest distance to a 16-QAM point, summed over a (2 n_half + 1)-symbol
    window (zero-padded), and the phase of the least sum (the first of
    equal sums)."""
    const = torch.as_tensor(qam16_gray(), device=y.device)
    ph = torch.arange(n_phases, device=y.device, dtype=torch.float32) * (math.pi / 2) / n_phases
    rot = torch.exp(1j * ph)
    n = y.shape[0]
    out = []
    for c0 in range(0, y.shape[1], chunk):
        z = rnd(y[:, c0:c0 + chunk, None] * rot)
        d = torch.full(z.shape, math.inf, device=y.device)
        for c in const:
            d = torch.minimum(d, rnd(torch.abs(z - c) ** 2))
        cs = torch.cat([torch.zeros_like(d[:1], dtype=torch.float64),
                        torch.cumsum(d.double(), dim=0)])
        hi = torch.clamp(torch.arange(n, device=y.device) + n_half + 1, max=n)
        lo = torch.clamp(torch.arange(n, device=y.device) - n_half, min=0)
        sums = cs[hi] - cs[lo]
        out.append(ph[torch.argmin(sums, dim=-1)])
    return torch.cat(out, dim=1)


def unwrap(p):
    d = torch.diff(p, dim=0)
    dm = torch.remainder(d + math.pi, 2 * math.pi) - math.pi
    dm = torch.where((dm == -math.pi) & (d > 0), torch.full_like(dm, math.pi), dm)
    corr = torch.where(torch.abs(d) < math.pi, torch.zeros_like(d), dm - d)
    return torch.cat([p[:1], p[1:] + torch.cumsum(corr.double(), dim=0).to(p.dtype)])


def dsp(sig_b, ref_b, cfg, rnd=ident, rnd_np=None):
    """The receiver chain on B signals: (carrier-recovered symbols, the
    equalizer's output before carrier recovery), each (B, nSym, 2)."""
    rxc = cfg["rx"]
    x = torch.stack([front_end(s, cfg, rnd) for s in sig_b])
    ref = torch.stack([pnorm(r) for r in ref_b])
    y = equalize(x.cpu().numpy(), ref.cpu().numpy(), cfg, rnd_np)
    y = torch.as_tensor(y, device=sig_b.device)
    b, n_sym, m = y.shape
    cols = y.transpose(0, 1).reshape(n_sym, b * m)
    ph = unwrap(4 * bps(cols, rxc["cpr_window"] // 2, rxc["cpr_phases"], rnd)) / 4
    return rnd((cols * torch.exp(1j * ph)).reshape(n_sym, b, m).transpose(0, 1)), y


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------

def scores(y, d, rnd=ident):
    """(BER, GMI, SNR dB) per column of (N, C) received ``y`` against the
    transmitted ``d``: OptiCommPy's fastBERcalc and monteCarloGMI (the
    received symbols rotated by mean(d / y), both normalized to unit power;
    GMI from the max-log-free bitwise LLRs under the estimated noise
    variance)."""
    y = rnd(y.to(torch.complex64))
    d = d.to(torch.complex64)
    y = rnd(torch.mean(d / y, dim=0, keepdim=True) * y)
    y = rnd(y / torch.sqrt(torch.mean((y * y.conj()).real, dim=0, keepdim=True)))
    d = d / torch.sqrt(torch.mean((d * d.conj()).real, dim=0, keepdim=True))
    snr = 10 * torch.log10(torch.mean(torch.abs(d) ** 2, dim=0)
                           / torch.mean(torch.abs(y - d) ** 2, dim=0))
    const = torch.as_tensor(qam16_gray(), device=y.device)
    bits = torch.as_tensor(bit_labels(16), device=y.device)
    iy = torch.argmin(torch.abs(y[..., None] - const) ** 2, dim=-1)
    idd = torch.argmin(torch.abs(d[..., None] - const) ** 2, dim=-1)
    ber = (bits[iy] != bits[idd]).float().mean(dim=(0, 2))
    e = y - d
    var = (torch.abs(e - e.mean(dim=0, keepdim=True)) ** 2).mean(dim=0)
    gmi = []
    bf = bits.to(torch.float32)
    for c in range(y.shape[1]):
        d2 = rnd(torch.abs(y[:, c, None] - const[None, :]) ** 2)
        lw = rnd(-d2 / var[c])
        w = rnd(torch.exp(lw - lw.max(dim=1, keepdim=True).values))
        llr = rnd(torch.log(rnd(w @ (1 - bf))) - torch.log(rnd(w @ bf)))
        llr = torch.clamp(llr, -500.0, 500.0)
        sign = 2 * bits[idd[:, c]].to(torch.float32) - 1
        pen = rnd(torch.logaddexp(torch.zeros_like(llr), sign * llr) / math.log(2.0))
        gmi.append(torch.sum(1.0 - pen.mean(dim=0)))
    return ber, torch.stack(gmi), snr
