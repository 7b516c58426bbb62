"""Drive the PyTorch port's coherent WDM, IM-DD, digital-backpropagation,
single-polarization, Giles-EDFA and perturbation-NLC paths and its
parallel routes once on one NVIDIA GPU.

Phases:
1. device: needs CUDA (exits non-zero otherwise); prints the card's
   ``nvidia-smi`` name and power limit; TF32 off for matmul and cuDNN.
2. build: compiles ``opticommpy_torch/csrc/*.cu`` with nvcc (one process
   per source, in parallel) into ``build/torch_kernels/``.
3. kernel vs plain: each Hopper kernel against its plain PyTorch version
   on the card, all timed with CUDA events: K1 blind phase search bit for
   bit (0 index mismatches, equal phases) at the chain's shape (65,536
   symbols x 2 modes, 64 test phases, 75-symbol window, 16-QAM grid), path
   C's (x 22 modes) and path I's (60,436 x 2, 16 points, window 51), on
   8-PSK and at small cases that run the rest of its instances
   (``BPS_CASES``), and its threshold slicer against the division on all
   2^32 float32 inputs per grid; K15, the unwrap with the derotation fused
   in, against its plain twin (turns and phases bit for bit) at the batch
   chain's and path C's 65,536 x 22, the chain's 65,536 x 2 and small cases
   (``UNWRAP_CASES``), timed beside today's PyTorch ops; K16, the adaptive
   Manakov step's start and trapezoidal pass, against its plain twin (the
   solver's PyTorch ops on the card) on the link's (2, 1, 2^20) field,
   timed beside those ops; K2, the MIMO
   equalizer, for each of its five rules at 4,096 symbols, 2x2, 15 taps,
   and at the main path's first training pass (12,000 symbols, da-rde); K3, the batched equalizer, for
   the five rules at B=3 x 4,096 symbols, bit-identical per signal to K2,
   and at B=11 x 12,000 symbols (da-rde); K5, the batched RLS, at B=11 x
   12,000 symbols for rls and dd-rls (lambda 0.99); K4, the single-signal
   RLS with the argmin slicer, on 8-PSK dd-rls at 4,096 symbols; K6, the
   Gardner loop, at 16,384 x 2 samples (Nyquist TED) and 4,096 x 2
   (classic), and on a short input where a stuff follows a backstep (and
   on path A's own input, phase 8); K7, the DD-PLL, at 65,536 symbols x 22
   columns with a pilot every 32nd symbol, bit for bit against its plain
   twin ``ddpll_plain`` and within PLL_ATOL of the reference rule
   ``carrier_recovery.ddpll``, with cycles per symbol at the SM clock.
4. main path, launch counters reset just before and read just after:
   ``simple_wdm_tx`` (11 channels of 16-QAM polmux, 32 GBd, SpS 16, 2**18
   bits = 2**20 samples, 37.5 GHz grid, -2 dBm/ch, RRC 0.01 with 1024 taps,
   100 kHz linewidth) -> ``manakov_ssf`` (5 x 50 km, hz 0.5 km, fused
   linear steps, EDFA NF 4.5) -> LO (10 dBm, 100 kHz, 150 MHz offset) ->
   ``pdm_coherent_receiver`` -> reference sync of the centre channel ->
   ``coherent_dsp_chain`` (both kernel backends) -> BER, GMI, EVM after
   nTrain + 2000 symbols.
5. checks: every kernel launched on the main path (BPS >= 1, equalizer >= 3
   passes); BER <= 2 x the JAX package's BER + 1e-4 and GMI >= its GMI -
   0.05 bit per polarization (JAX numbers from
   ``tools/jax_main_path_reference.py`` on the CPU); the chain on CUDA
   agrees with the chain on the CPU (the kernels' plain versions) on the
   first 4,096 symbols.
6. WDM receiver, on the main path's field: every channel k received with
   its own LO at ``wdm_freq_grid(11, 37.5e9)[k]`` + 150 MHz and
   synchronized against its own symbols, then the 11 signals through
   ``coherent_dsp_chain_batch`` twice, each with the counters reset just
   before and read just after: with ("da-rde", "dd-lms") (K3 3 launches,
   K1 1, K2 none) and with ("rls", "dd-rls") (K5 3 launches, K1 1). Per
   channel and polarization BER <= 2 x ref + 1e-4 and GMI >= ref - 0.05,
   where ref is the same chain on the same input on the CPU (the kernels'
   plain versions); against the JAX package (numbers from
   ``tools/jax_wdm_receiver_reference.py``), whose noise realization
   differs and whose channels each slip or not by chance, the same bounds
   on the median over channels and polarizations. Each batch chain runs
   twice more and whether the outputs are bit-identical is printed, as is
   whether the Tx and the SSFM give bit-identical fields from one seed.
7. 8-PSK receiver (counters reset and read): ``mimo_rls_kernel`` with
   dd-rls on a 65,536-symbol 8-PSK polmux signal, which runs K4 once;
   symbol errors after convergence checked.
8. clock recovery and serving, counters reset just before each and read
   just after; checked against the JAX package (numbers from
   ``tools/jax_cr_serve_reference.py``):
   A. the centre channel at a receiver clock 200 ppm fast (with sampling
      jitter) through ``coherent_dsp_chain`` with Gardner clock recovery on
      K6 (K6 1 launch, K2 3, K1 1); BER <= 2 x JAX + 1e-4 and GMI >= JAX -
      0.05 per polarization; run twice (bit-identity printed); K6 against
      its plain version on the input it got there (~131,100 x 2 samples) and
      timed on it (cycles per input sample at the SM clock read after the
      window); the same signal without clock recovery as the control;
   B. channel k of the WDM receiver at its own offset -200 + 40 k ppm
      through ``coherent_dsp_chain_batch`` with feedforward clock recovery
      (K3 3, K1 1, K6 none); the clock estimates printed; every channel
      and polarization against the same chain on the CPU (BER <= 2 x CPU +
      1e-4, GMI >= CPU - 0.05);
   C. every channel with its LO at its grid frequency, resampled to 64 GS/s;
      taps trained by ``mimo_adapt_equalizer_batch`` (K3 3), served by
      ``coherent_dsp_serve`` (K1 1, over 22 columns; checked against the
      staged mimo_apply + BPS composition, rel. err < 5e-2) and by the
      DD-PLL, ``cpr(alg="ddpll-pallas")`` with a pilot every 32nd symbol (K7
      1). B and C: every polarization printed; BER and GMI medians over the
      22 polarizations against the JAX package's.
9. K8-K12 vs plain: K8, the LDPC check update, at (18, 36, 360, 512); K9 and
   K10, the fused QC step's check-column update and variable totals, on the
   state after three plain fused steps of path E's LLRs at DVB-S2 R4/5, R9/10
   and R1/4; K11, the whole decode in one launch (NMSA-20, B = 512), flooding
   at R4/5 (path E's LLRs), R9/10 and R1/4 (all-zero codewords near each
   code's waterfall) against ``mega_decode_plain`` and the fused route (K9 +
   K10), layered at the same three rates, early exit against the fixed loop; K12,
   one lifted-circulant iteration, at AR4JA 8192 R1/2 (B = 1024) and 802.11n
   1944 R1/2 (L = 81); bf16 and f32 messages; every comparison exact.
10. LDPC decoding, counters reset just before each run and read just after:
   E. ``decode_ldpc`` on 512 encoded DVB-S2 64800 R4/5 codewords, BPSK over
      AWGN at Es/N0 2.3 dB, NMSA-20, 'auto': float32 and bfloat16 (the
      serving type) messages each on K11 (one launch per decode), fixed
      loop and early exit; the same float32 decodes on the fused route
      (``backend="fused"``, K9 = K10 = 21 fixed, = steps with early exit),
      equal to K11's bit for bit and held to the plain 'xla' route on the
      card (decisions, iterations, fails; totals < 1e-5 relative); the
      layered schedule with early exit on K11, whose mean iterations must
      be below 0.75 x flooding's; FER 0 on every run; early exit
      bit-identical to the fixed loop; decode ms and Mbit/s;
   F. ``make_qc_decoder(backend="pallas")`` on the same LLRs, bf16 NMSA-20:
      K8 20 launches, bit-identical to the bf16 'xla' route;
   D. the coded WDM link: 88 encoded R4/5 codewords, 8 per channel plus
      5,888 tail bits, 16-QAM mode-major on the north-star Tx and channel;
      path C's receiver, each input rolled by its symbol delay; taps by
      ``mimo_adapt_equalizer_batch`` (K3 3); ``coherent_coded_serve`` with
      512 pilot symbols and its default FEC config, NMSA-20 bfloat16 early
      exit (K1 1, K11 1, K9 = K10 = 0, no plain version); frames failed and
      post-FEC errors per channel, 0 of 88 failed and 0 errors required;
      channels 0, 5 and 10 again on the CPU (plain versions): the same fail
      flags and bits;
   G. ``decode_ldpc`` on AR4JA 8192 R1/2, NMSA-20 bfloat16, B = 1024 (the JAX
      package's ``run_ar4ja_decode`` workload) on K12 (20 launches):
      decisions, iterations and fail flags equal to the plain 'xla' lift
      route on the card; info Mbit/s; then the same at float32, and 802.11n
      1944 R1/2 (L = 81) at B = 1024 bfloat16, each on K12 (20 launches)
      and held to the plain route the same way.
11. K13 and K14 vs plain, every comparison exact: K13, the DFE/FFE
   recurrence, at the IM-DD serving shape (PAM4, B = 8 x 16,384 symbols,
   15 / 5 taps, the real instance) as DFE and FFE, a signal alone against
   the batch, the PAM4 input on the complex instance against the real one,
   and on the complex instance 16-QAM fulltime (per-axis quantizer) and
   8-PSK (argmin) at 8 x 4,096 (cycles per symbol of the DFE at the SM clock
   read after its window); K14, the Volterra recurrence, at
   bench_dsp.py's shape (B = 8 x 16,384 symbols, SpS 2, 13 / 7 / 5 taps,
   mu 1e-3, nTrain 4000) at order 2 and 3 (cycles per symbol at order 3),
   BER 0 after nTrain required; K14's two exact replacements of a division
   on every float32 input: its quotient by 7 against __fdiv_rn and its
   threshold slicer against the dividing one (PAM4 and PAM8 levels), no
   input may differ.
12. path H, IM-DD serving at the JAX package's bench size
   (bench.run_imdd_chain), counters reset just before each run and read
   just after: 8 links of PAM4 at 25 GBd, SpS 8, 2**17 bits (2**19
   samples), 3 dBm, built on the card by ``pam_tx_draw`` / ``pam_tx_build``
   -> ``linear_fiber_channel`` (10 km) -> ``photodiode`` (20 GHz); then
   ``imdd_dsp_chain_batch`` with the DFE and with the FFE (IMDDConfig taps
   15 / 5, mu 2e-3, nTrain 8000, fulltime; K13 1 launch each): every link's
   BER after 2 nTrain < 1e-3 and tail MSE < 0.05, the median BER within 2 x
   JAX + 1e-4 (numbers from ``tools/jax_imdd_reference.py``), and the chain
   on the first 16,384 symbols of every link on CUDA against the same on
   the CPU (plain version); warm ms and Msym/s at B = 8 and, time only, at
   B = 132; K13 alone on the arguments the chain gives it (8 x 65,536
   symbols, DFE and FFE: the shape the path launches), its time, cycles
   per symbol and bound, and every output against its plain version on
   the card on the same arguments, bit for bit; then the links' SpS-2 samples through
   ``volterra_kernel`` (order 3, 13 / 7 / 5; K14 1 launch), BER printed,
   the kernel against the plain version on the CPU on a 4,096-symbol
   prefix, and K14 alone on the arguments the path gives it (8 x 65,536
   symbols), its time and cycles per symbol.
13. path I, the digital-backpropagation link of BASELINE config 5
   (examples/nlc_dbp_transmission.py at 2**18 bits), counters reset just
   before and read just after: ``simple_wdm_tx`` (1 channel of 16-QAM
   polmux, 32 GBd, SpS 8, RRC 0.01 with 1024 taps, no linewidth) -> five
   copies at -2, 0, 2, 4 and 6 dBm by ``set_power_for_par_ssfm`` -> one
   ``manakov_ssf`` call (8 x 50 km, hz 0.25 km, ideal gain, fused) -> per
   power the matched filter and decimation to 2 SpS, then an EDC arm and a
   ``manakov_dbp`` arm (hz 5 km at 64 GS/s, after the rescale to the launch
   power), each through ``symbol_sync``, ``mimo_adapt_equalizer`` (nlms
   twice, then dd-lms, on K2) and ``cpr(alg="bps-pallas")`` (K1): K1 10
   launches and K2 30 required; per power, arm and polarization BER <= 2 x
   JAX + 1e-4 and GMI >= JAX - 0.05 (numbers from
   ``tools/jax_dbp_reference.py``), MI printed; wherever the JAX run's DBP
   arm beats its EDC arm by 0.5 dB of mean SNR, the port's must too; the
   same link once more from ``wdm_tx_build`` on the JAX run's own symbols
   (``tools/dbp_jax_seed7_symbols.npz``), each arm's mean SNR per power
   within SAME_SYMB_SNR_DB of the JAX run's (the DBP arm's BER and GMI
   are saturated, its SNR is not; counters not read for this run);
   ``manakov_ssf`` and ``manakov_dbp`` on a 2**14-sample prefix over one
   span on CUDA against the CPU (1e-4 relative); warm times of the forward
   SSFM, of ``manakov_dbp`` per power and of one arm's chain, and the
   peak memory, each beside the card's name and power limit.
14. phase J, the single-polarization functions at 2**20 samples or 2**16
   symbols: ``quantizer``, ``freq_shift``, ``pm``, ``voa``, ``detector``
   (MAP, ML), ``soft_mapper``, ``soft_estimator``, ``calc_extr_llr``,
   ``calc_mi``, ``monte_carlo_mi``, ``symbol_sync(mode="real")``,
   ``sync_data_sequences`` (both references), ``cazac_sequence``, the bit
   arrays and ``set_power_for_par_ssfm`` on CUDA against the same call on
   CPU tensors, each with its tolerance printed; ``symbol_source`` (2**24
   symbols, uniform and Maxwell-Boltzmann: every frequency within 1% of
   px), ``awgn``, ``adc`` / ``dac`` (ENOB below nBits, jitter) and
   ``ssfm`` with EDFAs by their noise statistics (within 2% of the model);
   the scalar ``ssfm`` over 5 x 50 km at hz 0.5, fused and not, one span
   against the CPU (1e-4 relative) and its warm time.
15. phase K (run after path B, on its received signals), the routes the
   JAX package runs outside any Pallas kernel, counters reset just before
   each run and read just after: K-chain, ``coherent_dsp_chain`` on the
   centre channel with blockUpdate 16 and mu (5e-3, 1e-3) (K1 1, K2 = K3 =
   0), BER <= 1e-2 and <= 2 x the same chain on the CPU + 1e-4, GMI >= CPU
   - 0.05 per polarization, warm ms and Msym/s beside the per-symbol
   chain's; K-batch, ``coherent_dsp_chain_batch`` over the 11 channels
   with the same config (K1 1, K3 0), each polarization that converges on
   the CPU against the same chain there, each channel against the batch
   chain on that channel alone, the median
   BER within 2 x the JAX package's blocked run + 1e-4
   (``tools/jax_blocked_wdm_reference.py``; 1e-2 printed); K-wl / K-store,
   ``mimo_adapt_equalizer`` with runWL (dd-lms; da-rde then dd-lms) and
   storeCoeff (nlms) on 4,096 symbols of the centre channel after EDC and
   FOE, CUDA against the CPU (Hiter's shape, its last row = H), ms per
   pass; K-mlse, ``mlse`` on 16,384 PAM4 symbols through h = [1, 0.45]
   and 16,384 16-QAM symbols through h = [1, 0.3 + 0.1j] (16 states),
   decisions equal to the CPU's, SER bounded, ms; K-whiten,
   ``estimate_whitening_filter`` at 2**20 samples, 8 taps, CUDA against
   the CPU within 1e-5 relative; the phase's time.
16. path L, the Giles-EDFA link of BASELINE config 4
   (examples/wdm_amp_transmission.py at the main path's widths), counters
   reset just before and read just after: ``simple_wdm_tx`` (11 channels
   of 16-QAM polmux, 32 GBd, SpS 16, 2**18 bits, 37.5 GHz grid, -2 dBm per
   channel, RRC 0.01 with 1024 taps, 100 kHz lasers) -> 3 x (50 km of
   ``manakov_ssf`` without gain, nlprMethod, maxNlinPhaseRot 2e-2 ->
   ``edfa_sm``: AGC 10 dB, 8 m of the synthetic EDF, 60 mW forward pump,
   no backward pump, 100 GHz noise band, tolCtrl 0.5 dB; its FFTs and
   ASE draw on the card, its boundary-value solver and PID loop on the
   host, as in the JAX package) -> the centre channel's LO at +80 MHz,
   ``pdm_coherent_receiver``, a 0.6 Rs low-pass of 501 taps, the matched
   filter, decimation to 2 SpS, ``edc`` over 150 km, ``symbol_sync``,
   ``mimo_adapt_equalizer`` (da-rde / dd-lms, 15 taps, mu (5e-3, 2e-3),
   2,000 training symbols, numIter 2) and ``cpr`` BPS (N 35, B 64): K2 3
   launches and K1 1 required, and the adaptive spans on K16 (its launches,
   CUDA graph replays counted, 2 a step and 3 a pass of the solver's own
   counters, read under a CPU profiler around ``manakov_ssf``); every span's
   gain within tolCtrl of 10 dB;
   BER <= 2 x JAX + 1e-4 and GMI >= JAX - 0.05 per polarization (numbers
   from ``tools/jax_edfa_link_reference.py``); the ASE draw's variance per
   bin within 2% of noise_amp**2; ``edfa_sm`` on a 2**16-sample prefix of
   span 1's input, noise zeroed, on CUDA against CPU tensors (pumps,
   noise amplitude, field within 1e-6 relative); per span the SSFM's
   seconds, the host solver's, the rest's, and the forward pump beside
   JAX's, with the card's name and power limit.
17. path M, the perturbation-NLC link (examples/perturbation_nlc.py with
   98,304 64-QAM symbols per polarization) on the JAX package's seed-7
   symbols (``tools/pert_jax_seed7_symbols.npz``), counters reset just
   before and read just after: five launch powers (-2 to 4 dBm in 1.5 dB
   steps) as ten columns of one ``manakov_ssf`` call (16 x 50 km, hz 0.5
   km, ideal gain); per power the matched filter, decimation, ``edc`` over
   800 km, ``symbol_sync``, ``mimo_adapt_equalizer`` (nlms twice, then
   dd-lms, on K2) and ``cpr(alg="bps-pallas")`` (K1): K1 5 launches and K2
   15 required; then three arms, EDC, NLC (``perturbation_nlin`` AMR,
   matrixOrder 50, coeffTol -30 dB, on the ML hard decisions, subtracted at
   the EVM-best of a 10 x 10 amplitude / phase grid) and NLC on the true
   symbols: BER <= 2 x JAX + 1e-4 per arm, power and polarization (numbers
   from ``tools/jax_pert_nlc_reference.py``); each arm's mean SNR within
   SAME_SYMB_SNR_DB of the JAX run's at every power where the JAX run's
   linear receiver holds the signal (-2 to 2.5 dBm); at 4 dBm, where it
   loses it (EDC BER 0.44, mean SNR -2.1 dB), the EDC and NLC arms must
   lose it too (BER > PERT_LOST_BER on both polarizations).
18. phase N: ``calc_nlin_perturbation`` ('fft', 'chunk') and its AMR form
   at 2**16 symbols, matrixOrder 25, ``modulate_ofdm`` and
   ``demodulate_ofdm`` (Nfft 256, CP 32, 16 pilots, ~2**20 samples, over
   40 km of ``linear_fiber_channel``), each on CUDA against the same call on
   CPU tensors, with warm times; a ``save_state`` / ``load_state`` round
   trip on the card; one ``StageTimer`` stage.
19. phase O, ``opticommpy_torch.parallel`` at world size 1 on NCCL (one
   card; world sizes 2 and 4 run on gloo in the CPU tests): NCCL start-up
   and an all-reduce; the main path's Tx field through ``manakov_ssf_dp``
   on a (1, 1) mesh with EDFAs and the main path's generator seed, bit for
   bit against ``manakov_ssf``; an adaptive span with the world group (K16's
   sums and maximum all-reduced) bit for bit against the span without one;
   ``manakov_ssf_pp`` (one stage, M = 1) and
   ``manakov_ssf_sp`` (default halo) with ideal gain, within PP_REL and
   SP_REL of ``manakov_ssf`` (sp propagates a longer block with a cyclic
   halo, so it is held to its halo bound, not bit for bit), and with EDFAs,
   output power 0.8-1.6 x the input; ``sharded_edc`` (L 250 km at the
   field's rate) and the RRC matched filter by ``sharded_fir`` on the dp
   output against ``edc`` + ``fir_filter`` (EDC_STEP_REL on the interior);
   path E's LLRs through the serving decoder (bf16 NMSA-20, early exit),
   path C's 11 training signals through ``mimo_adapt_equalizer_batch`` and
   path B's 11 offset signals through ``ffw_clock_recovery``, each split
   over the ``data`` dim, bit for bit with the unsharded call and the same
   launches (K11 1, K3 3); ``dryrun_multichip(1)``; every stage's
   host-clock time beside the card's name and power limit.
20. the time of every phase; then the kernels JSON line (K1-K16, each with
   its bound: bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s;
   K1 and K2 also with their path I, L and M launches, K1 with phase K's,
   K3 and K11 with phase O's), and last the ``{"ok": true, "device": ...}``
   line.

Usage: python3 chip_smoke.py
"""

import json
import os
import subprocess
import sys
import time
from fractions import Fraction

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# The JAX package (0.9.0) on the CPU at the same configuration, per
# polarization: JAX_PLATFORMS=cpu python tools/jax_main_path_reference.py
JAX_BER = (0.00016039350884966552, 0.0001652539212955162)
JAX_GMI = (3.9976260662078857, 3.9974942207336426)

# The JAX package (0.9.0) on the CPU at the WDM receiver's configuration,
# per channel (wdm_freq_grid order) and polarization:
# JAX_PLATFORMS=cpu python tools/jax_wdm_receiver_reference.py
JAX_WDM = {
    "da-rde/dd-lms": {
        "ber": ((0.017030874267220497, 0.01983046904206276),
                (2.430204585834872e-05, 1.9441637050476857e-05),
                (0.07539952546358109, 0.01874173805117607),
                (0.22153745591640472, 6.80457305861637e-05),
                (0.3827086389064789, 0.0),
                (0.0, 4.860409262619214e-06),
                (0.023368848487734795, 0.017069756984710693),
                (0.0, 0.0),
                (9.720818525238428e-06, 9.720818525238428e-06),
                (0.05900536850094795, 0.40994149446487427),
                (0.014070885255932808, 0.0013754958054050803)),
        "gmi": ((3.2259135246276855, 3.197892904281616),
                (3.9951305389404297, 3.995380401611328),
                (2.134824752807617, 3.221951961517334),
                (0.7447553873062134, 3.9989030361175537),
                (0.13728690147399902, 3.999997138977051),
                (3.9999923706054688, 3.999882221221924),
                (3.1183178424835205, 3.2072641849517822),
                (4.0, 3.9999992847442627),
                (3.9998843669891357, 3.9998855590820312),
                (2.428135633468628, -0.04863458871841431),
                (3.292764186859131, 3.8402929306030273))},
    "rls/dd-rls": {
        "ber": ((0.0010692899813875556, 0.0010352671379223466),
                (1.4581228242604993e-05, 1.9441637050476857e-05),
                (0.000121510231110733, 0.00018469555652700365),
                (0.0, 0.0),
                (0.0, 0.0),
                (4.860409262619214e-06, 4.860409262619214e-06),
                (0.0, 0.0),
                (0.0, 0.0),
                (9.720818525238428e-06, 9.720818525238428e-06),
                (0.0, 2.430204585834872e-05),
                (0.00017983514408115298, 0.00012637063628062606)),
        "gmi": ((3.39670467376709, 3.401531219482422),
                (3.9963152408599854, 3.9960179328918457),
                (3.9058847427368164, 3.883934259414673),
                (3.9999985694885254, 3.9999988079071045),
                (3.999997854232788, 3.999988317489624),
                (3.999959945678711, 3.999906301498413),
                (3.9999985694885254, 3.999997615814209),
                (3.9999988079071045, 3.9999890327453613),
                (3.999882936477661, 3.999645709991455),
                (3.999971389770508, 3.999647855758667),
                (3.9953064918518066, 3.9970946311950684))},
}

# The JAX package (0.9.0) on the CPU at the clock-recovery and serving
# paths' configuration (A per polarization; B and C per channel, wdm_freq_grid
# order, and polarization): JAX_PLATFORMS=cpu python tools/jax_cr_serve_reference.py
JAX_CR_A = dict(
    ber=(0.0003987085656262934, 0.0005737513420172036),
    gmi=(3.992408514022827, 3.989628791809082),
    no_cr_ber=(0.49610042572021484, 0.4985947906970978))
# phase K's K-batch: the 11-channel receiver of JAX_WDM with ("da-rde",
# "dd-lms"), mu (5e-3, 1e-3), blockUpdate 16 (the blocked route), per
# channel and polarization, and the medians over the 22 polarizations:
# JAX_PLATFORMS=cpu python tools/jax_blocked_wdm_reference.py (113 s on 8
# CPU cores). The same steps without blocking (blockUpdate 1) give a median
# BER of 7.69e-2: the step of the dd-lms stage, not the blocking, leaves
# these channels unconverged.
JAX_BLOCKED_WDM = dict(
    ber=((0.07721246, 0.30062118), (2.43e-05, 1.944e-05), (0.33069253, 0.34438917),
         (0.31555235, 0.31530932), (0.30331385, 0.23457307), (0.07212361, 0.09567229),
         (0.08519325, 0.3164418), (0.00019442, 3.888e-05), (1.944e-05, 4.86e-06),
         (0.05640019, 0.39666772), (0.00107901, 0.00031593)),
    median_ber=0.08120285719633102, median_gmi=2.0679636001586914)
JAX_CR_BC = {
    'B ffw': {
        "ber": (
            (0.0007345787598751485, 0.45795875787734985),
            (3.891807864420116e-05, 0.002490757033228874),
            (0.1848219484090805, 0.028541546314954758),
            (0.49599143862724304, 0.4926980137825012),
            (0.20180968940258026, 0.008454952389001846),
            (0.008654408156871796, 0.00849873572587967),
            (0.4983313977718353, 0.008255497552454472),
            (0.00853278860449791, 0.00858630146831274),
            (0.008625219576060772, 0.008741972967982292),
            (0.45290428400039673, 0.44293150305747986),
            (0.48891809582710266, 0.0874878391623497)),
        "gmi": (
            (3.709331512451172, -0.16413676738739014),
            (3.996995687484741, 3.7849771976470947),
            (0.9791037440299988, 2.9767465591430664),
            (-0.2444852590560913, -0.23667633533477783),
            (0.25694578886032104, 3.2175042629241943),
            (3.2101480960845947, 3.1776034832000732),
            (-0.2510122060775757, 3.2180352210998535),
            (3.234224796295166, 3.22464656829834),
            (3.324087142944336, 3.3177335262298584),
            (-0.14715832471847534, -0.11944949626922607),
            (-0.22201454639434814, 2.050748348236084))},
    'C serve': {
        "ber": (
            (0.0011130337370559573, 0.0009818027028813958),
            (4.3743682908825576e-05, 2.430204585834872e-05),
            (0.00013123104872647673, 0.00016039350884966552),
            (0.0, 0.00043743682908825576),
            (0.0, 0.47092506289482117),
            (0.4703806936740875, 0.0),
            (0.0, 0.0),
            (0.0, 0.0),
            (0.4922865629196167, 0.43566763401031494),
            (0.0, 4.860409262619214e-06),
            (7.290613575605676e-05, 7.776654820190743e-05)),
        "gmi": (
            (3.510382652282715, 3.437070846557617),
            (3.993643283843994, 3.994194984436035),
            (3.9178881645202637, 3.8834617137908936),
            (3.999978542327881, 3.9931395053863525),
            (4.0, -0.20552432537078857),
            (-0.17223966121673584, 3.9999985694885254),
            (4.0, 4.0),
            (4.0, 4.0),
            (-0.23359286785125732, -0.14249610900878906),
            (3.999987840652466, 3.9999537467956543),
            (3.9978244304656982, 3.9973018169403076))},
    'C ddpll': {
        "ber": (
            (0.0011762190843001008, 0.001258846023119986),
            (0.0002867641451302916, 0.0002478808746673167),
            (0.00019927677931264043, 0.00011664982594083995),
            (0.0, 0.0666750967502594),
            (4.860409262619214e-06, 0.33536824584007263),
            (0.4131688177585602, 9.720818525238428e-06),
            (0.0, 0.0),
            (1.4581228242604993e-05, 0.0),
            (0.4817977845668793, 0.2213381826877594),
            (0.0, 0.0),
            (0.01914515160024166, 0.00020899760420434177)),
        "gmi": (
            (3.5345776081085205, 3.510385036468506),
            (3.964319944381714, 3.9679439067840576),
            (3.974628448486328, 3.934098243713379),
            (3.9999887943267822, 2.2430520057678223),
            (3.9998416900634766, 0.4977568984031677),
            (0.09003567695617676, 3.999669075012207),
            (3.9999992847442627, 4.0),
            (3.9999048709869385, 4.0),
            (-0.1968017816543579, 1.3611117601394653),
            (3.999986171722412, 3.99999737739563),
            (3.0697131156921387, 3.9938511848449707))},
}

# The JAX package (0.9.0) on the CPU at path H's configuration, per link
# (BER after 2 nTrain, MSE of the last 4,000 symbols):
# JAX_PLATFORMS=cpu python tools/jax_imdd_reference.py
# The same tool runs the JAX Volterra scan on the K14 phase's 8 rows: BER 0
# after nTrain on every row at order 2 and 3, the gate that phase holds.
JAX_IMDD = {
    "dfe": ((0.0, 0.0014324813382700086),
            (0.0, 0.0013805757043883204),
            (0.0, 0.001427816809155047),
            (0.0, 0.0013922563521191478),
            (0.0, 0.0013749608770012856),
            (0.0, 0.0013732515508309007),
            (0.0, 0.0014070846373215318),
            (0.0, 0.0013923271326348186)),
    "ffe": ((0.0, 0.0014838691568002105),
            (0.0, 0.0014339707558974624),
            (0.0, 0.0014776047319173813),
            (0.0, 0.0014470398891717196),
            (0.0, 0.0014234490226954222),
            (0.0, 0.0014236016431823373),
            (0.0, 0.0014578639529645443),
            (0.0, 0.0014408150454983115)),
}

# The JAX package (0.9.0) on the CPU at path I's configuration (the DBP link of
# BASELINE config 5), per launch power [dBm] and arm, per polarization: BER,
# GMI, MI and SNR [dB] after the first 5,000 and before the last 100 symbols:
# JAX_PLATFORMS=cpu python tools/jax_dbp_reference.py (517 s on 8 CPU cores)
JAX_DBP = {
    -2.0: {
        "edc": dict(
            ber=(0.0, 0.0),
            gmi=(4.0, 4.0),
            mi=(3.9997527599334717, 4.002316951751709),
            snr=(27.13178825378418, 27.077377319335938),
        ),
        "dbp": dict(
            ber=(0.0, 0.0),
            gmi=(4.0, 4.0),
            mi=(4.0197954177856445, 4.009955406188965),
            snr=(35.51251983642578, 35.55844497680664),
        ),
    },
    0.0: {
        "edc": dict(
            ber=(0.0, 0.0),
            gmi=(4.0, 4.0),
            mi=(3.9988718032836914, 4.001983165740967),
            snr=(25.093801498413086, 25.01097869873047),
        ),
        "dbp": dict(
            ber=(0.0, 0.0),
            gmi=(4.0, 4.0),
            mi=(4.014058589935303, 4.007803440093994),
            snr=(34.605743408203125, 34.657371520996094),
        ),
    },
    2.0: {
        "edc": dict(
            ber=(0.0, 1.2409822375047952e-05),
            gmi=(3.9999990463256836, 3.9996485710144043),
            mi=(3.9981775283813477, 4.001372337341309),
            snr=(22.198528289794922, 22.1007080078125),
        ),
        "dbp": dict(
            ber=(0.0, 0.0),
            gmi=(4.0, 4.0),
            mi=(4.007630348205566, 4.005365371704102),
            snr=(32.950721740722656, 33.00785446166992),
        ),
    },
    4.0: {
        "edc": dict(
            ber=(0.0005460322136059403, 0.0006039447034709156),
            gmi=(3.982875108718872, 3.9783108234405518),
            mi=(3.9806559085845947, 3.9798872470855713),
            snr=(18.674238204956055, 18.576274871826172),
        ),
        "dbp": dict(
            ber=(0.0, 0.0),
            gmi=(4.0, 4.0),
            mi=(4.000840187072754, 4.00271463394165),
            snr=(28.727807998657227, 28.63926124572754),
        ),
    },
    6.0: {
        "edc": dict(
            ber=(0.009282547049224377, 0.0100809121504426),
            gmi=(3.80523681640625, 3.789936065673828),
            mi=(3.80283522605896, 3.790647506713867),
            snr=(14.725078582763672, 14.61874008178711),
        ),
        "dbp": dict(
            ber=(0.0, 0.0),
            gmi=(4.0, 4.0),
            mi=(3.9995779991149902, 4.002255916595459),
            snr=(26.801372528076172, 26.766929626464844),
        ),
    },
}

EQ_Y_ATOL, EQ_H_ATOL = 2e-4, 1e-3  # the JAX package's scan-vs-kernel pins
CR_ATOL, PLL_ATOL = 1e-5, 2e-4  # Gardner kernel vs loop; DD-PLL kernel vs scan
SERVE_REL = 5e-2  # serve vs the staged composition (tests/test_pipelines.py:293)
# roofline of one H100 SXM (NVIDIA's data sheet): device memory and float32
# outside the tensor cores
HBM_BYTES_PER_S, FP32_FLOP_PER_S = 3.35e12, 67e12
PPM_A = 200.0
PPM_B = tuple(-200.0 + 40.0 * k for k in range(11))
PILOT_EVERY = 32


def _cuda_ms(fn, reps, warmup=True):
    """Mean milliseconds per call of ``fn`` over ``reps`` calls (CUDA events)."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, kernel, reps, per_call=1):
    """(mean device milliseconds per call of ``fn`` in the kernels whose name
    holds ``kernel``, device kernels of any name per call), by
    torch.profiler: without the host's gaps between calls, which CUDA
    events around back-to-back calls include. ``per_call`` is how many such
    kernels one call launches (None: any number)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    mine = [e for e in kernels if kernel in e.name]
    if per_call is not None and len(mine) != per_call * reps:
        names = {}
        for e in mine:
            names[e.name] = names.get(e.name, 0) + 1
        _check(False, f"profiler saw {len(mine)} {kernel} launches for {reps} calls, expected "
               f"{per_call * reps}: {names}")
    mine = [e.self_device_time_total for e in mine]
    return sum(mine) / reps / 1e3, len(kernels) / reps


def _sm_clock_mhz():
    """The card's SM clock now (MHz), as nvidia-smi reads it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0])


def _with_cycles(entry, n_sym, sm_mhz):
    """Add the SM clock read after the timed window and the cycles one
    symbol of one signal took: ms / n_sym x clocks.sm (recurrences are bound
    by the latency of one symbol's step)."""
    entry["sm_clock_mhz"] = sm_mhz
    entry["cycles_per_symbol"] = entry["ms"] * 1e-3 / n_sym * sm_mhz * 1e6
    return entry


def _wall(fn):
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of the bytes over the card's memory
    rate and the float32 operations over its peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bps_cost(n, modes, n_phases, m_points=None):
    """(bytes, flops) of BPS: complex64 in, float32 phases out; per (symbol,
    test phase) a rotation and the square-QAM distance (~25 operations) or
    the minimum over ``m_points`` points (6 each, 10 besides), and the
    window sum as a running sum (an add and a subtract)."""
    per = 25 + 2 if m_points is None else 6 * m_points + 10
    return n * modes * (8 + 4), n * modes * n_phases * per


def _eq_cost(n_batch, n_sym, modes=2, n_taps=15, sps=2):
    """(bytes, flops) of one gradient-rule pass: the padded signal, the
    references and the output (complex64); per symbol the filter and the
    rank-1 update, modes x modes x taps complex multiply-adds each."""
    nbytes = n_batch * 8 * modes * (sps * n_sym + 2 * n_taps + n_sym + n_sym)
    return nbytes, n_batch * n_sym * (2 * 8 * modes * modes * n_taps + 20)


def _rls_cost(n_batch, n_sym, modes=2, n_taps=15, sps=2):
    """(bytes, flops) of one RLS pass: as the gradient rules, plus per symbol
    and mode the four taps x taps complex products of the Sd update."""
    nbytes, flops = _eq_cost(n_batch, n_sym, modes, n_taps, sps)
    return nbytes, flops + n_batch * n_sym * modes * 4 * 8 * n_taps * n_taps


def _gardner_cost(n_in, n_out, modes, iterations):
    """(bytes, flops) of the Gardner loop: complex64 in, complex64 and f32
    out; ~40 float operations per iteration (the data decides how many)."""
    return modes * (8 * n_in + 12 * n_out), 40 * iterations


def _ddpll_cost(n, n_cols, n_pilots):
    """(bytes, flops) of the DD-PLL: the signal (complex64), the reference
    symbols of the pilot rows only (complex64) and the pilot mask in, f32
    phases out; ~40 float operations per symbol and column (sine and cosine
    counted as ~10 each)."""
    return n * n_cols * (8 + 4) + n_pilots * n_cols * 8 + 4 * n, 40 * n * n_cols


def _with_bound(entry, nbytes, flops):
    entry["bound_ms"], entry["bound_by"] = _bound(nbytes, flops)
    entry["library_ms"] = None  # no single PyTorch call computes this function
    return entry


def _smi():
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    print(_smi())  # name, power limit: exactly as nvidia-smi prints them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    return torch.device("cuda:0")


def phase_build():
    from opticommpy_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.build_info.get('seconds', 0.0):.2f} s)")
    for line in _build.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())


def _noisy(rng, n, modes, const, snr_db=22.0, lw_ts=2e-6):
    sym = const[rng.integers(0, len(const), size=(n, modes))]
    phi = np.cumsum(rng.normal(scale=np.sqrt(2 * np.pi * lw_ts), size=(n, modes)), axis=0)
    sigma = np.sqrt(10 ** (-snr_db / 10) / 2)
    noise = sigma * (rng.normal(size=(n, modes)) + 1j * rng.normal(size=(n, modes)))
    return (sym * np.exp(1j * phi) + noise).astype(np.complex64)


def _polmux(dev, const, n_sym, seed):
    """(padded signal (rows, 2), symbols (n_sym, 2)) on ``dev``: symbols of
    ``const`` at 2 samples/symbol through a fixed 2x2 mixing matrix, noise
    0.01, padded by 7 zeros in front and 7 + 2 + 15 behind (15 taps)."""
    r = np.random.default_rng(seed)
    sym = const[r.integers(0, len(const), size=(n_sym, 2))]
    x = np.zeros((n_sym * 2, 2), complex)
    x[::2] = sym
    h = np.array([[0.9, 0.15 + 0.05j], [-0.1 + 0.08j, 0.95]])
    sig = x @ h.T + 0.01 * (r.normal(size=x.shape) + 1j * r.normal(size=x.shape))
    pad = np.zeros((7 + 2 * n_sym + 7 + 2 + 15, 2), np.complex64)
    pad[7:7 + 2 * n_sym] = sig
    return (torch.as_tensor(pad, device=dev),
            torch.as_tensor(sym.astype(np.complex64), device=dev))


def _polmux_batch(dev, const, n_batch, n_sym, seed):
    pairs = [_polmux(dev, const, n_sym, seed + b) for b in range(n_batch)]
    return torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])


def _spike(dev, n_batch, n_taps=15):
    h0 = torch.zeros((n_batch, 2, 2, n_taps), dtype=torch.complex64, device=dev)
    h0[:, [0, 1], [0, 1], n_taps // 2] = 1.0
    return h0


def phase_batch_kernels_vs_plain(dev, const):
    """K3, K4 and K5 against their plain versions on the card."""
    from opticommpy_torch.kernels import mimo_eq, rls

    report = {}
    # K3: five rules at B=3 x 4096, and bit-identity with K2 per signal
    h_flat = _spike(dev, 3).permute(0, 1, 3, 2).reshape(3, 2, 30)
    worst, k2_diff = 0.0, 0.0
    for i, alg in enumerate(("lms", "nlms", "cma", "rde", "da-rde")):
        sig_pad, ref = _polmux_batch(dev, const, 3, 4096, 100 + 10 * i)
        args = (const, mimo_eq.stage_aux(alg, const), alg, 1e-3,
                1000 if alg == "lms" else 4096, 2, 15, 0, 4096)
        y_k, h_k = mimo_eq.mimo_eq_stage_batch(sig_pad, ref, h_flat, *args)
        y_p, h_p = mimo_eq.mimo_eq_stage_batch_plain(sig_pad, ref, h_flat, *args)
        singles = [mimo_eq.mimo_eq_stage(sig_pad[b], ref[b], h_flat[b], *args)
                   for b in range(3)]
        y_err = float((y_k - y_p).abs().max())
        h_err = float((h_k - h_p).abs().max())
        same = max(max(float((y_k[b] - ys).abs().max()), float((h_k[b] - hs).abs().max()))
                   for b, (ys, hs) in enumerate(singles))
        ms = _cuda_ms(lambda: mimo_eq.mimo_eq_stage_batch(sig_pad, ref, h_flat, *args), 10)
        plain_ms = _cuda_ms(lambda: mimo_eq.mimo_eq_stage_batch_plain(
            sig_pad, ref, h_flat, *args), 1, warmup=False)
        print(f"K3 mimo_eq_batch {alg} (B=3 x 4096 sym, 2x2, 15 taps): max |y err| "
              f"{y_err:.3e}, max |H err| {h_err:.3e}, max |K3 - K2| {same:.1e}, "
              f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms")
        _check(y_err < EQ_Y_ATOL and h_err < EQ_H_ATOL,
               f"batched equalizer kernel disagrees with plain ({alg})")
        _check(same == 0.0, f"K3 is not bit-identical to K2 per signal ({alg})")
        _check(bool(torch.isfinite(y_k).all()), f"K3 output not finite ({alg})")
        worst, k2_diff = max(worst, y_err), max(k2_diff, same)

    # K3 at the WDM path's first training pass: B=11 x 12000 symbols, da-rde
    sig_pad, ref = _polmux_batch(dev, const, 11, 12000, 200)
    h_flat = _spike(dev, 11).permute(0, 1, 3, 2).reshape(11, 2, 30)
    args = (const, mimo_eq.stage_aux("da-rde", const), "da-rde", 5e-3, 0, 2, 15, 0, 12000)
    ms = _cuda_ms(lambda: mimo_eq.mimo_eq_stage_batch(sig_pad, ref, h_flat, *args), 5)
    sm_mhz = _sm_clock_mhz()
    plain_ms = _cuda_ms(lambda: mimo_eq.mimo_eq_stage_batch_plain(
        sig_pad, ref, h_flat, *args), 1, warmup=False)
    y_k, _ = mimo_eq.mimo_eq_stage_batch(sig_pad, ref, h_flat, *args)
    y_p, _ = mimo_eq.mimo_eq_stage_batch_plain(sig_pad, ref, h_flat, *args)
    err = float((y_k - y_p).abs().max())
    print(f"K3 mimo_eq_batch da-rde (B=11 x 12000 sym, 2x2, 15 taps): max |y err| "
          f"{err:.3e}, kernel {ms:.3f} ms, plain {plain_ms:.1f} ms")
    _check(err < EQ_Y_ATOL, "batched equalizer kernel disagrees with plain (B=11)")
    report["mimo_eq_batch"] = _with_cycles(_with_bound(
        dict(max_abs_err=max(worst, err), ms=ms, plain_ms=plain_ms), *_eq_cost(11, 12000)),
        12000, sm_mhz)
    report["k3_vs_k2_max_abs_diff"] = k2_diff

    # K5: the batched RLS at B=11 x 12000 symbols, lambda 0.99 (the chain's)
    sd0 = torch.eye(15, dtype=torch.complex64, device=dev).repeat(11, 2, 1, 1)
    h0 = _spike(dev, 11)
    worst, times = 0.0, []
    for alg in ("rls", "dd-rls"):
        args = (sig_pad, ref, h0, sd0, const, alg, 0.99, 2, 15, 0, 12000)
        y_k, h_k, s_k = rls.rls_stage_batch(*args)
        y_p, h_p, s_p = rls.rls_stage_plain(*args)
        y_err = float((y_k - y_p).abs().max())
        h_err = float((h_k - h_p).abs().max())
        sd_rel = float((s_k - s_p).abs().max() / s_p.abs().max())
        ms = _cuda_ms(lambda: rls.rls_stage_batch(*args), 3)
        sm_mhz = _sm_clock_mhz()
        plain_ms = _cuda_ms(lambda: rls.rls_stage_plain(*args), 1, warmup=False)
        print(f"K5 rls_batch {alg} (B=11 x 12000 sym, 2x2, 15 taps, lambda 0.99): "
              f"max |y err| {y_err:.3e}, max |H err| {h_err:.3e}, Sd rel err "
              f"{sd_rel:.3e}, kernel {ms:.3f} ms, plain {plain_ms:.1f} ms")
        _check(y_err < EQ_Y_ATOL and h_err < EQ_H_ATOL and sd_rel < EQ_H_ATOL,
               f"RLS kernel disagrees with plain ({alg})")
        _check(bool(torch.isfinite(y_k).all()), f"K5 output not finite ({alg})")
        worst = max(worst, y_err)
        times.append((ms, plain_ms, sm_mhz))
    report["rls_batch"] = _with_cycles(_with_bound(
        dict(max_abs_err=worst, ms=times[0][0], plain_ms=times[0][1]), *_rls_cost(11, 12000)),
        12000, times[0][2])
    report["rls_batch"]["dd_rls_ms"] = times[1][0]

    # K4: the single-signal RLS with the argmin slicer, 8-PSK dd-rls
    psk = np.exp(2j * np.pi * np.arange(8) / 8).astype(np.complex64)
    sig_pad, ref = _polmux(dev, psk, 4096, 300)
    args = (sig_pad, ref, _spike(dev, 1)[0], sd0[0], psk, "dd-rls", 0.99, 2, 15, 0, 4096)
    y_k, h_k, s_k = rls.rls_stage(*args)
    y_p, h_p, s_p = rls.rls_stage_plain(*(a[None] for a in args[:4]), *args[4:])
    y_err = float((y_k - y_p[0]).abs().max())
    h_err = float((h_k - h_p[0]).abs().max())
    ms = _cuda_ms(lambda: rls.rls_stage(*args), 5)
    sm_mhz = _sm_clock_mhz()
    plain_ms = _cuda_ms(lambda: rls.rls_stage_plain(*(a[None] for a in args[:4]), *args[4:]),
                        1, warmup=False)
    print(f"K4 rls argmin dd-rls 8-PSK (4096 sym, 2x2, 15 taps, lambda 0.99): max |y err| "
          f"{y_err:.3e}, max |H err| {h_err:.3e}, kernel {ms:.3f} ms, plain {plain_ms:.1f} ms")
    _check(y_err < EQ_Y_ATOL and h_err < EQ_H_ATOL, "K4 disagrees with plain (8-PSK)")
    report["rls_argmin"] = _with_cycles(_with_bound(
        dict(max_abs_err=y_err, ms=ms, plain_ms=plain_ms), *_rls_cost(1, 4096)), 4096, sm_mhz)
    return report


# K1's cases: (label, constellation, N, modes, n_half, B). The chain's,
# path C's and path I's calls (16 points in registers), 8-PSK, and small
# ones that run the rest of the kernel's instances and edges: 4-QAM on the
# grid of 2 levels at n_half 0 and an odd N, 64-QAM on the searched grid, 64
# points in shared memory at B 32.
BPS_CASES = (
    ("chain", "qam16", 65536, 2, 37, 64),
    ("path C", "qam16", 65536, 22, 37, 64),
    ("path I", "qam16 tensor", 60436, 2, 25, 64),
    ("8-PSK", "psk8", 20000, 2, 37, 64),
    ("4-QAM, n_half 0", "qam4", 1001, 3, 0, 32),
    ("64-QAM", "qam64", 4099, 2, 12, 64),
    ("64 points", "qam64 tensor", 3001, 1, 25, 32),
)
BPS_TIMED = ("chain", "path C", "path I")


def _bps_const(kind):
    """A K1 case's constellation as the callers pass it: a NumPy array (the
    grid where it is a square QAM) or, as ``cpr`` passes it, a CPU tensor."""
    from opticommpy_torch.comm.modulation import norm_const

    name = kind.split()[0]
    if name == "psk8":
        c = np.exp(2j * np.pi * np.arange(8) / 8).astype(np.complex64)
    else:
        c = np.asarray(norm_const(int(name[3:]), "qam"), np.complex64)
    return torch.as_tensor(c) if kind.endswith("tensor") else c


def phase_bps_kernel(dev, rng):
    """K1 against ``bps_indices_plain`` at every case of BPS_CASES: 0 index
    mismatches and the phases ``bps_kernel`` writes equal to the plain
    indices' phases, one launch counted per call; times at the main path's
    shapes; the threshold slicer of every grid the cases use against the
    division on all 2^32 float32 inputs."""
    from opticommpy_torch.kernels import bps

    report = None
    grids = {}
    for label, kind, n, modes, n_half, n_ph in BPS_CASES:
        c = _bps_const(kind)
        c_np = np.asarray(c)
        sig = torch.as_tensor(_noisy(rng, n, modes, c_np), device=dev)
        before = bps.launches
        est_k = bps.bps_kernel(sig, n_half, c, n_ph)
        idx_k = bps.bps_indices(sig, n_half, c, n_ph)
        n_launch = bps.launches - before
        idx_p = bps.bps_indices_plain(sig, n_half, c, n_ph)
        est_p = bps._test_phases(n_ph, dev)[0][idx_p]
        torch.cuda.synchronize()
        mismatch = int((idx_k != idx_p).sum())
        same_phase = bool(torch.equal(est_k, est_p))
        err = float((est_k - est_p).abs().max())
        grid = None
        if isinstance(c, np.ndarray):
            grid = bps._square_qam_levels(c.real, c.imag)
        if grid is not None:
            grids[grid] = bps.slicer_tables(*grid)[0]
        route = ("grid, selects" if grid and grids[grid] == bps.GRID4 else
                 "grid, search" if grid else f"{len(c_np)} points")
        line = (f"K1 bps {label} ({n}x{modes}, B={n_ph}, n_half={n_half}, {route}): "
                f"index mismatches {mismatch} of {idx_p.numel()}, phases equal {same_phase}, "
                f"launches {n_launch} for 2 calls")
        entry = dict(max_abs_err=err, index_mismatches=mismatch)
        if label in BPS_TIMED:
            entry["ms"] = _cuda_ms(lambda: bps.bps_kernel(sig, n_half, c, n_ph), 20)
            entry["sm_clock_mhz"] = _sm_clock_mhz()
            entry["device_ms"], per_call = _device_ms(
                lambda: bps.bps_kernel(sig, n_half, c, n_ph), "bps_kernel", 20)
            _check(per_call == 1, f"bps_kernel launched {per_call} kernels a call, not K1 "
                   f"alone ({label})")
            entry["plain_ms"] = _cuda_ms(lambda: bps.bps_indices_plain(sig, n_half, c, n_ph), 3)
            entry["cycles_per_symbol"] = (entry["ms"] * 1e-3 * entry["sm_clock_mhz"] * 1e6
                                          / (n * modes))
            _with_bound(entry, *_bps_cost(n, modes, n_ph, None if grid else len(c_np)))
            line += (f"; kernel {entry['ms']:.4f} ms ({entry['cycles_per_symbol']:.2f} cycles "
                     f"per symbol and mode at {entry['sm_clock_mhz']:.0f} MHz), plain "
                     f"{entry['plain_ms']:.2f} ms, bound {entry['bound_ms']:.5f} ms "
                     f"({entry['bound_by']}, {entry['bound_ms'] / entry['ms']:.1%}); the "
                     f"kernel's own device time {entry['device_ms']:.4f} ms "
                     f"({entry['bound_ms'] / entry['device_ms']:.1%} of the bound; profiler)")
        print(line)
        _check(mismatch == 0 and same_phase and n_launch == 2,
               f"K1 disagrees with its plain version or did not launch once a call ({label})")
        if report is None:
            report = entry
        else:
            report.setdefault("cases", {})[label] = entry
    for (lo, step, n_lev), route in grids.items():
        t0 = time.perf_counter()
        count, first = bps.bps_exact_check(lo, step, n_lev, dev)
        print(f"K1 threshold slicer vs the division over all 2^32 float32 inputs ({n_lev} "
              f"levels, lo {lo}, step {step}, route {route}; {time.perf_counter() - t0:.3f} s): "
              f"{count} differ {first}")
        _check(count == 0, f"K1's threshold slicer differs from the division ({n_lev} levels)")
    return report


# K15's cases: (label, N, C, m). The batch chain's and path C's 11 polmux
# signals, the single chain's 2 modes, and small ones: one chunk (352 rows
# at 22 columns), a last chunk of one row, more columns than one CTA takes,
# m = 1 as V&V's unwrap runs.
UNWRAP_CASES = (
    ("batch chain, path C", 65536, 22, 4),
    ("chain", 65536, 2, 4),
    ("one chunk", 352, 22, 4),
    ("a row over", 353, 22, 4),
    ("40 columns", 70001, 40, 4),
    ("m 1", 5000, 3, 1),
)
UNWRAP_TIMED = ("batch chain, path C", "chain")


def _unwrap_cost(n, cols):
    """(bytes, flops) of K15: float32 phases and complex64 symbols read and
    both written once; ~40 float operations an element (sincosf ~20)."""
    return n * cols * (4 + 8) * 2, 40 * n * cols


def phase_unwrap_kernel(dev, rng):
    """K15 against its plain twin at every case of UNWRAP_CASES: turns and
    phases bit for bit, derotated symbols within 1e-6 of |y|, one call
    counted a call, two runs bit-identical; at the main path's shapes its
    time (CUDA events; device time by torch.profiler) beside its bound,
    the PyTorch ops it replaced (the float corrections of 4 phi summed
    along the rows, over 4, and ``y * exp(1j theta)``) as ``plain``, and
    its plain twin with the integer scan along the inner dim as ``twin``."""
    from opticommpy_torch.kernels import _build
    from opticommpy_torch.kernels import unwrap as tunwrap
    from opticommpy_torch.utils.scan import cumsum

    report = None
    for label, n, cols, m in UNWRAP_CASES:
        p = np.cumsum(rng.normal(scale=0.8, size=(n, cols)), axis=0)
        phi = torch.as_tensor((np.mod(p, 2 * np.pi) / m).astype(np.float32), device=dev)
        y = torch.as_tensor(_noisy(rng, n, cols, np.asarray(_bps_const("qam16"))), device=dev)
        before = tunwrap.launches
        got = tunwrap.unwrap_derotate_kernel(phi, y, m)
        again = tunwrap.unwrap_derotate_kernel(phi, y, m)
        n_launch = tunwrap.launches - before
        theta_p, y_p = tunwrap.unwrap_derotate_plain(phi, y, m)
        torch.cuda.synchronize()
        turns_equal = bool(torch.equal(tunwrap.turns(got[0], phi, m),
                                       tunwrap.turns(theta_p, phi, m)))
        phases_equal = bool(torch.equal(got[0], theta_p))
        y_err = float((got[1] - y_p).abs().max()) / float(y.abs().max())
        repeat = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
        line = (f"K15 unwrap {label} ({n}x{cols}, m={m}): turns equal {turns_equal}, phases "
                f"equal {phases_equal}, symbols max rel err {y_err:.2e}, two runs "
                f"bit-identical {repeat}, launches {n_launch} for 2 calls")
        entry = dict(max_abs_err=y_err, turns_equal=turns_equal, phases_equal=phases_equal)
        if label in UNWRAP_TIMED:
            call = lambda: tunwrap.unwrap_derotate_kernel(phi, y, m)  # noqa: E731
            per_call = 2 if _build.load_library().unwrap_scratch_len(n, cols) else 1

            def plain():
                # the PyTorch ops K15 replaced: the float corrections summed
                # along the rows by utils/scan.cumsum (an outer-dim scan)
                x = m * phi
                rest = x[1:] + cumsum(tunwrap.step_corrections(x, 0), dim=0)
                return y * torch.exp(1j * (torch.cat([x[:1], rest]) / m))

            def twin():
                # K15's plain twin with its integer scan along the inner dim
                theta, out = tunwrap.unwrap_derotate_plain(phi.t().contiguous(),
                                                           y.t().contiguous(), m, dim=1)
                return theta.t().contiguous(), out.t().contiguous()
            entry["ms"] = _cuda_ms(call, 50)
            entry["device_ms"], _ = _device_ms(call, "unwrap_", 50, per_call)
            entry["plain_ms"] = _cuda_ms(plain, 10)
            entry["twin_ms"] = _cuda_ms(twin, 20)
            entry["twin_device_ms"], entry["twin_kernels"] = _device_ms(twin, "", 20, None)
            entry["twin_equal"] = bool(torch.equal(twin()[0], got[0]))
            _with_bound(entry, *_unwrap_cost(n, cols))
            line += (f"; kernel {entry['ms']:.4f} ms (device {entry['device_ms']:.4f} ms in "
                     f"{per_call} launches), plain {entry['plain_ms']:.3f} ms, twin with an "
                     f"inner-dim scan {entry['twin_ms']:.4f} ms (device "
                     f"{entry['twin_device_ms']:.4f} ms in {entry['twin_kernels']:.0f} "
                     f"kernels, phases equal {entry['twin_equal']}), bound "
                     f"{entry['bound_ms']:.5f} ms ({entry['bound_by']}, "
                     f"{entry['bound_ms'] / entry['ms']:.1%} by the call, "
                     f"{entry['bound_ms'] / entry['device_ms']:.1%} by device time)")
        print(line)
        _check(turns_equal and phases_equal and y_err <= 1e-6 and repeat and n_launch == 2,
               f"K15 disagrees with its plain twin or did not launch once a call ({label})")
        if report is None:
            report = entry
        else:
            report.setdefault("cases", {})[label] = entry
    return report


SSFM_PASS_FIELD = (2, 1, 2**20)  # the link's field: 2 polarizations of 2^20 samples


def _ssfm_pass_cost(b, n):
    """(bytes, flops) of K16 on a (2, b, n) complex64 field, per sample of
    both polarizations: a pass reads e_conv and e_hd (32 bytes) and pch (4)
    and writes the rotated field (16), reads and writes the spectrum (32)
    with lin_op once (8 a column), reads e_fd and e_conv (32) and writes the
    field (16); a step's start reads the field (16), writes pch (4), reads
    lin_arg and writes lin_op (16 a column) and reads and writes the
    spectrum (32). ~120 float operations a sample in a pass (sincosf ~20,
    four hypotf), ~30 in a step's start."""
    m = b * n
    return (132 * m + 8 * n, 120 * m), (52 * m + 16 * n, 30 * m)


def phase_ssfm_pass_kernel(dev):
    """K16 on the link's (2, 1, 2^20) field against its plain twin, the
    PyTorch ops of the solver's CPU route run on the card: a step's start
    (power, FFT, lin forming lin_op, unnormalized inverse FFT) and a
    trapezoidal pass (rotate, FFT, lin, unnormalized inverse FFT, converge
    writing the field), the fields and the convergence number within 1e-6
    relative, two runs bit-identical, 2 and 3 launches; their device time
    by torch.profiler (K16's kernels alone, and the PyTorch ops' kernels
    other than cuFFT's) and their time with cuFFT by CUDA events, beside
    the byte bound at 3.35 TB/s."""
    from opticommpy_torch.kernels import ssfm_pass
    from opticommpy_torch.models import SSFMConfig
    from opticommpy_torch.models import channels as tch

    _, b, n = SSFM_PASS_FIELD
    g = torch.Generator(device=dev).manual_seed(16)
    e = torch.complex(torch.randn(SSFM_PASS_FIELD, generator=g, device=dev),
                      torch.randn(SSFM_PASS_FIELD, generator=g, device=dev)) * 0.06
    cfg = SSFMConfig(Ltotal=50, Lspan=50, alpha=0.2, D=16, gamma=1.3, Fs=512e9,
                     nlprMethod=True, maxNlinPhaseRot=2e-2)
    lin_arg = tch._lin_arg(n, cfg, e.dtype, dev)
    span_end = torch.full((), 50.0, device=dev)
    z, status = torch.zeros((), device=dev), torch.zeros(2, device=dev)

    def k16_start():
        z.zero_()
        return tch._step_start(e, z, span_end, lin_arg, cfg, status)

    pch, hz, lin_op, e_hd = k16_start()
    conv = e.clone()

    def k16_pass():  # as a graph's pass: the field written over its estimate
        e_fd = tch._trap_pass(conv, e_hd, pch, lin_op, hz, cfg.gamma, 1.0)
        tch._converge(e_fd, conv, status, write=True)
        return e_fd

    def plain_start():
        pch_p, phi_max = tch._power_plain(e, cfg.gamma)
        hz_p = torch.minimum(cfg.maxNlinPhaseRot / phi_max, span_end - 0.0)
        lin_p = torch.exp(lin_arg * (hz_p / 2))
        return pch_p, hz_p, lin_p, tch._ifft(tch._fft(e) * lin_p)

    def plain_pass():
        e_fd = tch._ifft(tch._fft(tch._rotate_plain(e, e_hd, pch, hz, cfg.gamma, 1.0)) * lin_op)
        num, den = tch._converge_sums_plain(e_fd, e)
        lim = torch.stack([torch.sqrt(num) / torch.sqrt(den), status[1]])
        conv.copy_(e_fd)
        return e_fd, lim

    before = ssfm_pass.launches
    e_fd = k16_pass()
    lim = status[0].item()
    n_pass = ssfm_pass.launches - before
    conv.copy_(e)
    again = k16_pass()
    repeat = bool(torch.equal(e_fd, again)) and status[0].item() == lim
    before = ssfm_pass.launches
    start2 = k16_start()
    n_start = ssfm_pass.launches - before
    repeat = repeat and all(bool(torch.equal(u, v)) for u, v in zip((pch, hz, lin_op, e_hd),
                                                                     start2))
    want_start = plain_start()
    want_fd, want_lim = plain_pass()
    torch.cuda.synchronize()
    rel = lambda a, w: float(torch.linalg.vector_norm(a - w) / torch.linalg.vector_norm(w))  # noqa: E731
    errs = dict(pch=rel(pch, want_start[0]), hz=rel(hz, want_start[1]),
                lin_op=rel(lin_op, want_start[2]), e_hd=rel(e_hd, want_start[3]),
                e_fd=rel(e_fd, want_fd), lim=abs(lim - want_lim[0].item()) / want_lim[0].item())
    k16_names = ("power_kernel", "lin_kernel", "rotate_kernel", "converge_kernel")

    def device_ms(fn, keep, reps=50):
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        mine = [ev for ev in prof.events() if ev.device_type.name == "CUDA" and keep(ev.name)]
        return sum(ev.self_device_time_total for ev in mine) / reps / 1e3, len(mine) / reps

    is_k16 = lambda name: any(k in name for k in k16_names)  # noqa: E731
    not_fft = lambda name: "fft" not in name.lower()  # noqa: E731
    (pass_bytes, pass_flops), (start_bytes, start_flops) = _ssfm_pass_cost(b, n)
    entry = dict(max_abs_err=max(errs.values()), errs=errs, bit_identical=repeat,
                 launches_per_pass=n_pass, launches_per_step_start=n_start)
    entry["ms"], _ = device_ms(k16_pass, is_k16)
    entry["device_ms"] = entry["ms"]
    entry["start_ms"], _ = device_ms(k16_start, is_k16)
    entry["plain_ms"], entry["plain_kernels"] = device_ms(plain_pass, not_fft)
    entry["plain_start_ms"], entry["plain_start_kernels"] = device_ms(plain_start, not_fft)
    entry["pass_with_fft_ms"] = _cuda_ms(k16_pass, 50)
    entry["plain_pass_with_fft_ms"] = _cuda_ms(plain_pass, 50)
    entry["start_with_fft_ms"] = _cuda_ms(k16_start, 50)
    entry["plain_start_with_fft_ms"] = _cuda_ms(plain_start, 50)
    _with_bound(entry, pass_bytes, pass_flops)
    entry["start_bound_ms"], _ = _bound(start_bytes, start_flops)
    print(f"K16 ssfm_pass {SSFM_PASS_FIELD}: errs {errs}, two runs bit-identical {repeat}, "
          f"launches {n_pass} a pass, {n_start} a step's start; pass: K16 "
          f"{entry['ms']:.4f} ms of device time, the PyTorch ops' non-FFT kernels "
          f"{entry['plain_ms']:.4f} ms in {entry['plain_kernels']:.0f}, with cuFFT "
          f"{entry['pass_with_fft_ms']:.4f} / {entry['plain_pass_with_fft_ms']:.4f} ms, bound "
          f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}, "
          f"{entry['bound_ms'] / entry['ms']:.1%}); step's start: K16 {entry['start_ms']:.4f} "
          f"ms, PyTorch {entry['plain_start_ms']:.4f} ms in "
          f"{entry['plain_start_kernels']:.0f}, with cuFFT {entry['start_with_fft_ms']:.4f} / "
          f"{entry['plain_start_with_fft_ms']:.4f} ms, bound {entry['start_bound_ms']:.4f} ms "
          f"({_smi()})")
    _check(max(errs.values()) <= 1e-6 and repeat and n_pass == 3 and n_start == 2,
           "K16 disagrees with its plain twin, differs between runs or launched other than "
           "3 kernels a pass and 2 a step's start")
    return entry


def phase_kernels_vs_plain(dev, const):
    from opticommpy_torch.kernels import mimo_eq

    report = {"bps": phase_bps_kernel(dev, np.random.default_rng(1))}
    report["unwrap"] = phase_unwrap_kernel(dev, np.random.default_rng(15))
    report["ssfm_pass"] = phase_ssfm_pass_kernel(dev)

    # K2: the adaptive equalizer recurrence, each rule
    def polmux(n_sym, seed):
        return _polmux(dev, const, n_sym, seed)

    h0 = torch.zeros((2, 2, 15), dtype=torch.complex64, device=dev)
    h0[[0, 1], [0, 1], 7] = 1.0
    h_flat = h0.permute(0, 2, 1).reshape(2, 30)
    worst = 0.0
    for i, alg in enumerate(("lms", "nlms", "cma", "rde", "da-rde")):
        sig_pad, ref = polmux(4096, 10 + i)
        args = (sig_pad, ref, h_flat, const, mimo_eq.stage_aux(alg, const), alg, 1e-3,
                1000 if alg == "lms" else 4096, 2, 15, 0, 4096)
        y_k, h_k = mimo_eq.mimo_eq_stage(*args)
        (y_p, h_p), plain_s = _wall(lambda: mimo_eq.mimo_eq_stage_plain(*args))
        y_err = float((y_k - y_p).abs().max())
        h_err = float((h_k - h_p).abs().max())
        ms = _cuda_ms(lambda: mimo_eq.mimo_eq_stage(*args), 10)
        print(f"K2 mimo_eq {alg} (4096 sym, 2x2, 15 taps): max |y err| {y_err:.3e}, "
              f"max |H err| {h_err:.3e}, kernel {ms:.3f} ms, plain {plain_s * 1e3:.1f} ms")
        _check(y_err < EQ_Y_ATOL and h_err < EQ_H_ATOL,
               f"equalizer kernel disagrees with plain ({alg})")
        _check(bool(torch.isfinite(y_k).all()), f"equalizer output not finite ({alg})")
        worst = max(worst, y_err)

    # the main path's first training pass: 12000 symbols of da-rde
    sig_pad, ref = polmux(12000, 20)
    args = (sig_pad, ref, h_flat, const, mimo_eq.stage_aux("da-rde", const), "da-rde",
            5e-3, 0, 2, 15, 0, 12000)
    ms = _cuda_ms(lambda: mimo_eq.mimo_eq_stage(*args), 5)
    sm_mhz = _sm_clock_mhz()
    (y_p, _), plain_s = _wall(lambda: mimo_eq.mimo_eq_stage_plain(*args))
    y_k, _ = mimo_eq.mimo_eq_stage(*args)
    err = float((y_k - y_p).abs().max())
    print(f"K2 mimo_eq da-rde (12000 sym, 2x2, 15 taps): max |y err| {err:.3e}, "
          f"kernel {ms:.3f} ms, plain {plain_s * 1e3:.1f} ms")
    _check(err < EQ_Y_ATOL, "equalizer kernel disagrees with plain (12000 symbols)")
    report["mimo_eq"] = _with_cycles(_with_bound(
        dict(max_abs_err=max(worst, err), ms=ms, plain_ms=plain_s * 1e3), *_eq_cost(1, 12000)),
        12000, sm_mhz)
    return report


def run_main_path(dev, n_bits=2**18, n_channels=11, n_train=12000):
    from opticommpy_torch.comm.metrics import calc_evm, fast_ber_calc, monte_carlo_gmi
    from opticommpy_torch.dsp import EDCConfig, edc
    from opticommpy_torch.models import (LaserConfig, PDMFrontendConfig, SSFMConfig,
                                         basic_laser_model, manakov_ssf,
                                         pdm_coherent_receiver)
    from opticommpy_torch.models.tx import WDMTxConfig, simple_wdm_tx, wdm_freq_grid
    from opticommpy_torch.ops import decimate, fir_filter, pnorm, pulse_shape, symbol_sync
    from opticommpy_torch.pipelines import CoherentDSPConfig, coherent_dsp_chain

    gen = torch.Generator(device=dev).manual_seed(0)
    times = {}
    cfg_tx = WDMTxConfig(M=16, Rs=32e9, SpS=16, nBits=n_bits, nChannels=n_channels,
                         nPolModes=2, nFilterTaps=1024, pulseRollOff=0.01,
                         powerPerChannel=(-2.0,), wdmGridSpacing=37.5e9,
                         laserLinewidth=100e3)
    fs = cfg_tx.Fs
    (sig_tx, symb_tx, _), times["tx_s"] = _wall(lambda: simple_wdm_tx(gen, cfg_tx))
    cfg_ch = SSFMConfig(Ltotal=250, Lspan=50, hz=0.5, alpha=0.2, D=16, gamma=1.3,
                        Fs=fs, amp="edfa", NF=4.5, nlprMethod=False, trapIters=1,
                        fusedLinear=True)
    gen_state_ssfm = gen.get_state()
    sig_ch, times["ssfm_s"] = _wall(lambda: manakov_ssf(sig_tx, cfg_ch, gen))
    lo = basic_laser_model(LaserConfig(P=10.0, lw=100e3, Ns=sig_ch.shape[0], Fs=fs,
                                       freqShift=150e6, RIN_var=0.0), gen)
    sig_rx = pdm_coherent_receiver(sig_ch, lo, PDMFrontendConfig(Fs=fs), generator=gen)
    centre = int(np.flatnonzero(wdm_freq_grid(n_channels, 37.5e9) == 0.0)[0])
    pre = decimate(fir_filter(pulse_shape("rrc", 16, 1024, 0.01), sig_rx), 16, 2)
    pre = edc(pre, EDCConfig(L=250, D=16, Fs=64e9, Rs=32e9))
    d_ref = pnorm(symbol_sync(pre, symb_tx[:, :, centre], 2))
    cfg = CoherentDSPConfig(SpS_in=16, L=250, nTrain=n_train, mu=(5e-3, 2e-3),
                            eqBackend="pallas", cprBackend="pallas")
    (y, phases), times["dsp_s"] = _wall(lambda: coherent_dsp_chain(sig_rx, d_ref, cfg))
    disc = cfg.nTrain + 2000
    yy, dd = y[disc:-100], d_ref[disc:-100]
    ber, _, snr = fast_ber_calc(yy, dd, 16, "qam")
    gmi, _ = monte_carlo_gmi(yy, dd, 16, "qam")
    evm = calc_evm(yy, 16, "qam", symb_tx=dd)
    out = dict(sig_tx=sig_tx, symb_tx=symb_tx, sig_ch=sig_ch, sig_rx=sig_rx, d_ref=d_ref, y=y,
               phases=phases, cfg=cfg, cfg_ch=cfg_ch, gen=gen, gen_state_ssfm=gen_state_ssfm,
               ber=ber.cpu().numpy(), gmi=gmi.cpu().numpy(), evm=evm.cpu().numpy(),
               snr=snr.cpu().numpy())
    return out, times


def receive_wdm(res, n_channels=11):
    """Every channel of the main path's field through its own LO and front
    end: (received signals (B, N, 2), synchronized references (B, nSym, 2))."""
    from opticommpy_torch.dsp import EDCConfig, edc
    from opticommpy_torch.models import (LaserConfig, PDMFrontendConfig,
                                         basic_laser_model, pdm_coherent_receiver)
    from opticommpy_torch.models.tx import wdm_freq_grid
    from opticommpy_torch.ops import decimate, fir_filter, pnorm, pulse_shape, symbol_sync

    sig_ch, gen = res["sig_ch"], res["gen"]
    fs = 16 * 32e9
    pulse = pulse_shape("rrc", 16, 1024, 0.01)
    sigs, refs = [], []
    for k, f_k in enumerate(wdm_freq_grid(n_channels, 37.5e9)):
        lo = basic_laser_model(LaserConfig(P=10.0, lw=100e3, Ns=sig_ch.shape[0], Fs=fs,
                                           freqShift=float(f_k) + 150e6, RIN_var=0.0), gen)
        sig_rx = pdm_coherent_receiver(sig_ch, lo, PDMFrontendConfig(Fs=fs), generator=gen)
        pre = edc(decimate(fir_filter(pulse, sig_rx), 16, 2),
                  EDCConfig(L=250, D=16, Fs=64e9, Rs=32e9))
        refs.append(pnorm(symbol_sync(pre, res["symb_tx"][:, :, k], 2)))
        sigs.append(sig_rx)
    return torch.stack(sigs), torch.stack(refs)


def _wdm_scores(y, ref, disc):
    """Per channel (BER, GMI, EVM) arrays of shape (2,) after ``disc`` symbols."""
    from opticommpy_torch.comm.metrics import calc_evm, fast_ber_calc, monte_carlo_gmi

    rows = []
    for k in range(y.shape[0]):
        yy, dd = y[k, disc:-100], ref[k, disc:-100]
        ber, _, _ = fast_ber_calc(yy, dd, 16, "qam")
        gmi, _ = monte_carlo_gmi(yy, dd, 16, "qam")
        evm = calc_evm(yy, 16, "qam", symb_tx=dd)
        rows.append(tuple(t.cpu().numpy() for t in (ber, gmi, evm)))
    return rows


def run_wdm_paths(dev, res, n_channels=11, n_train=12000):
    """The 11-channel receiver: both training schedules through
    coherent_dsp_chain_batch, each with its launch counts."""
    from dataclasses import replace

    from opticommpy_torch.kernels import bps, mimo_eq, rls
    from opticommpy_torch.kernels import unwrap as tunwrap
    from opticommpy_torch.pipelines import CoherentDSPConfig, coherent_dsp_chain_batch

    (sig_b, ref_b), rx_s = _wall(lambda: receive_wdm(res, n_channels))
    n_sym = ref_b.shape[1]
    print(f"WDM receive: {rx_s:.3f} s for {n_channels} channels, signals "
          f"{tuple(sig_b.shape)}")
    cfg = CoherentDSPConfig(SpS_in=16, L=250, nTrain=n_train, mu=(5e-3, 2e-3),
                            eqBackend="pallas", cprBackend="pallas")
    failures, out = [], {}
    for name, algs in (("da-rde/dd-lms", ("da-rde", "dd-lms")),
                       ("rls/dd-rls", ("rls", "dd-rls"))):
        cfg_s = replace(cfg, alg=algs)
        bps.launches = tunwrap.launches = mimo_eq.launches = mimo_eq.batch_launches = 0
        rls.launches = rls.batch_launches = 0
        (y, phases), first_s = _wall(lambda: coherent_dsp_chain_batch(sig_b, ref_b, cfg_s))
        counts = dict(bps=bps.launches, unwrap=tunwrap.launches, mimo_eq=mimo_eq.launches,
                      mimo_eq_batch=mimo_eq.batch_launches, rls=rls.launches,
                      rls_batch=rls.batch_launches)
        print(f"WDM {name} launches: {counts}")
        if name == "da-rde/dd-lms":
            expect = dict(bps=1, unwrap=1, mimo_eq=0, mimo_eq_batch=3, rls=0, rls_batch=0)
        else:
            expect = dict(bps=1, unwrap=1, mimo_eq=0, mimo_eq_batch=0, rls=0, rls_batch=3)
        _check(counts == expect, f"WDM {name}: launches {counts}, expected {expect}")
        _check(tuple(y.shape) == (n_channels, n_sym, 2) and y.device == dev
               and tuple(phases.shape) == (n_sym, 2 * n_channels),
               f"unexpected output {tuple(y.shape)}")
        _check(bool(torch.isfinite(y).all()), f"WDM {name}: non-finite output")
        (y2, _), warm_s = _wall(lambda: coherent_dsp_chain_batch(sig_b, ref_b, cfg_s))
        y3, _ = coherent_dsp_chain_batch(sig_b, ref_b, cfg_s)
        same = bool(torch.equal(y, y2)) and bool(torch.equal(y2, y3))
        print(f"WDM {name}: first {first_s:.3f} s, warm {warm_s:.3f} s, "
              f"{n_channels * n_sym / warm_s / 1e6:.4f} Msym/s aggregate; three runs "
              f"bit-identical: {same} (max |diff| {float((y - y2).abs().max()):.3e})")
        disc = cfg.nTrain + 2000
        scores = _wdm_scores(y, ref_b, disc)
        # the same chain on the same input on the CPU (the kernels' plain
        # versions): the per-channel reference
        (y_cpu, _), cpu_s = _wall(lambda: coherent_dsp_chain_batch(
            sig_b.cpu(), ref_b.cpu(), cfg_s))
        d = (y.cpu() - y_cpu).abs()
        print(f"WDM {name} batch chain on the CPU (plain versions, all channels): "
              f"{cpu_s:.1f} s, CUDA vs CPU max |diff| {float(d.max()):.3e}, share > "
              f"1e-3: {float((d > 1e-3).float().mean()):.2e}")
        cpu = _wdm_scores(y_cpu, ref_b.cpu(), disc)
        jax_ber, jax_gmi = JAX_WDM[name]["ber"], JAX_WDM[name]["gmi"]
        far = (d > 1e-3).float().mean(dim=(1, 2))  # per channel
        for k, (ber, gmi, evm) in enumerate(scores):
            print(f"  ch {k:2d}: CUDA vs CPU share > 1e-3 {float(far[k]):.2e}; "
                  f"BER {ber[0]:.3e} {ber[1]:.3e} (CPU {cpu[k][0][0]:.3e} "
                  f"{cpu[k][0][1]:.3e}, JAX {jax_ber[k][0]:.3e} {jax_ber[k][1]:.3e}), "
                  f"GMI {gmi[0]:.4f} {gmi[1]:.4f} (CPU {cpu[k][1][0]:.4f} "
                  f"{cpu[k][1][1]:.4f}, JAX {jax_gmi[k][0]:.4f} {jax_gmi[k][1]:.4f}), "
                  f"EVM {evm[0]:.4f} {evm[1]:.4f}")
            for p in range(2):
                if not (ber[p] <= 2 * cpu[k][0][p] + 1e-4 and gmi[p] >= cpu[k][1][p] - 0.05):
                    failures.append(f"{name} ch {k} pol {p}: BER {ber[p]:.3e} GMI "
                                    f"{gmi[p]:.4f} vs CPU {cpu[k][0][p]:.3e} "
                                    f"{cpu[k][1][p]:.4f}")
        # against the JAX package, whose noise realization differs: the
        # median over channels and polarizations
        med_ber = float(np.median([r[0] for r in scores]))
        med_gmi = float(np.median([r[1] for r in scores]))
        jax_med_ber = float(np.median(jax_ber[:n_channels]))
        jax_med_gmi = float(np.median(jax_gmi[:n_channels]))
        n_ok = sum(int(r[0][p] < 1e-3) for r in scores for p in range(2))
        n_ok_jax = sum(int(b < 1e-3) for r in jax_ber[:n_channels] for b in r)
        print(f"WDM {name}: median BER {med_ber:.3e} (JAX {jax_med_ber:.3e}), median GMI "
              f"{med_gmi:.4f} (JAX {jax_med_gmi:.4f}); polarizations with BER < 1e-3: "
              f"{n_ok} of {2 * n_channels} (JAX {n_ok_jax})")
        if not (med_ber <= 2 * jax_med_ber + 1e-4 and med_gmi >= jax_med_gmi - 0.05):
            failures.append(f"{name}: median BER {med_ber:.3e} GMI {med_gmi:.4f} vs JAX "
                            f"{jax_med_ber:.3e} {jax_med_gmi:.4f}")
        out[name] = dict(counts=counts, warm_s=warm_s, same=same, cfg=cfg_s)
    _check(not failures, "WDM bounds failed:\n  " + "\n  ".join(failures))
    out["received"] = (sig_b, ref_b)
    return out


def run_psk_path(dev, n_sym=65536):
    """8-PSK polmux through mimo_rls_kernel (dd-rls): the K4 route."""
    from opticommpy_torch.kernels import rls

    psk = np.exp(2j * np.pi * np.arange(8) / 8).astype(np.complex64)
    sig_pad, sym = _polmux(dev, psk, n_sym, 400)
    sig = sig_pad[7:7 + 2 * n_sym]
    rls.launches = rls.batch_launches = 0
    (y, H, Sd), s = _wall(lambda: rls.mimo_rls_kernel(sig, None, psk, alg="dd-rls",
                                                      n_taps=15, sps=2, lam=0.99))
    counts = dict(rls=rls.launches, rls_batch=rls.batch_launches)
    c = torch.as_tensor(psk, device=dev)
    dec = c[torch.argmin((y[2000:, :, None] - c).abs(), dim=-1)]
    ser = float((dec != sym[2000:]).float().mean())
    print(f"8-PSK dd-rls (mimo_rls_kernel, {n_sym} sym): {s:.3f} s, launches {counts}, "
          f"SER after 2000 symbols {ser:.2e}")
    _check(counts == dict(rls=1, rls_batch=0), f"8-PSK path launches {counts}")
    _check(bool(torch.isfinite(y).all()) and ser < 1e-3, f"8-PSK path SER {ser}")
    return counts


def _cr_wave(dev, const, n_sym, seed, ppm):
    """(N, 2) 16-QAM polmux at 2 samples/symbol (RRC 0.1, 256 taps),
    resampled to a clock ``ppm`` fast, on ``dev``."""
    from opticommpy_torch.ops import clock_sampling_interp, fir_filter, pulse_shape, upsample

    r = np.random.default_rng(seed)
    sym = torch.as_tensor(const[r.integers(0, len(const), size=(n_sym, 2))], device=dev)
    x = fir_filter(pulse_shape("rrc", 2, 256, 0.1), upsample(sym, 2))
    return clock_sampling_interp(x, 1.0, 1.0 / (1 + ppm * 1e-6))


def phase_clock_pll_kernels(dev, const, n_cmp=16384, n_pll=65536):
    """K6 on short inputs and K7 against their plain versions on the card,
    and K7's time."""
    from opticommpy_torch.dsp.carrier_recovery import ddpll as ddpll_rule
    from opticommpy_torch.kernels import ddpll, gardner

    report = {}
    # K6: the Gardner loop, Nyquist TED (path A's) and classic, 2 modes
    pad = torch.zeros((1, 2), dtype=torch.complex64, device=dev)
    wave = _cr_wave(dev, const, n_cmp // 2, 60, 250.0)
    worst = 0.0
    # the plain loop costs ~1 ms per sample (H100 80GB HBM3 at 700 W,
    # PERF.md): the classic TED on a quarter of the length
    for nyquist, n in ((True, n_cmp), (False, n_cmp // 4)):
        x = torch.cat([wave[:n - 1], pad])
        n_out = int((1 - 500e-6) * x.shape[0])
        eo_k, tv_k, n_k = gardner.gardner_records(x, 2e-3, 1e-5, nyquist, n_out)
        (eo_p, tv_p, n_p), plain_s = _wall(
            lambda: gardner.gardner_plain(x, 2e-3, 1e-5, nyquist, n_out))
        e_err = float((eo_k - eo_p).abs().max())
        t_err = float((tv_k - tv_p).abs().max())
        same_n = bool(torch.equal(n_k, n_p))
        exact = bool(torch.equal(eo_k, eo_p)) and bool(torch.equal(tv_k, tv_p)) and same_n
        ms = _cuda_ms(lambda: gardner.gardner_records(x, 2e-3, 1e-5, nyquist, n_out), 3)
        print(f"K6 gardner ({'nyquist' if nyquist else 'classic'}, {x.shape[0]} x 2 samples, "
              f"250 ppm): max |eo err| {e_err:.3e}, max |t err| {t_err:.3e}, n_final equal "
              f"{same_n} {n_k.tolist()}, bit for bit {exact}, kernel {ms:.3f} ms, plain "
              f"{plain_s * 1e3:.1f} ms")
        _check(e_err < CR_ATOL and t_err < CR_ATOL and same_n and exact,
               f"Gardner kernel disagrees with plain (nyquist={nyquist})")
        worst = max(worst, e_err, t_err)
    # a stuff two iterations after a backstep (high loop gain, short input)
    r = np.random.default_rng(34)
    xb = torch.as_tensor(np.concatenate([
        (r.normal(size=(400, 1)) + 1j * r.normal(size=(400, 1))).astype(np.complex64),
        np.zeros((1, 1), np.complex64)]), device=dev)
    k_out = gardner.gardner_records(xb, 0.2, 0.0, False, 400)
    p_out = gardner.gardner_plain(xb, 0.2, 0.0, False, 400)
    same = all(bool(torch.equal(a, b)) for a, b in zip(k_out, p_out))
    print(f"K6 gardner, a stuff after a backstep (400 samples, kp 0.2): kernel equals plain "
          f"{same}")
    _check(same, "Gardner kernel disagrees with plain after a backstep")
    # path A's own input is compared and timed in run_cr_path_a
    report["gardner_short_err"] = worst

    # K7: the DD-PLL over 22 columns with a pilot every PILOT_EVERY-th symbol,
    # against its plain twin (the kernel's own rule in torch ops) bit for bit
    # and the reference rule carrier_recovery.ddpll within PLL_ATOL
    r = np.random.default_rng(62)
    tx = const[r.integers(0, 16, size=(n_pll, 22))]
    phi = np.cumsum(r.normal(scale=np.sqrt(2 * np.pi * 2e-6), size=(n_pll, 22)), axis=0)
    noise = 0.05 * (r.normal(size=(n_pll, 22)) + 1j * r.normal(size=(n_pll, 22)))
    xs = torch.as_tensor((tx * np.exp(1j * phi) + noise).astype(np.complex64), device=dev)
    ref = torch.as_tensor(tx.astype(np.complex64), device=dev)
    pilot = torch.zeros(n_pll, device=dev)
    pilot[::PILOT_EVERY] = 1.0
    loop = (1 / 32e9, 0.1, 1 / (2 * np.pi * 10e6), 1 / (2 * np.pi * 10e6))
    est_k = ddpll.ddpll_phases(xs, ref, pilot, const, *loop)
    est_t, twin_s = _wall(lambda: ddpll.ddpll_plain(xs, ref, pilot, const,
                                                    ddpll.loop_coefs(*loop)))
    est_p, rule_s = _wall(lambda: ddpll_rule(
        xs, *loop, torch.as_tensor(const, device=dev), symb_tx=ref,
        pilot_ind=np.arange(0, n_pll, PILOT_EVERY)))
    twin_err = float((est_k - est_t).abs().max())
    same = bool(torch.equal(est_k, est_t))
    err = float((est_k - est_p).abs().max())
    ms = _cuda_ms(lambda: ddpll.ddpll_phases(xs, ref, pilot, const, *loop), 5)
    sm_mhz = _sm_clock_mhz()
    print(f"K7 ddpll ({n_pll} x 22 columns, 16-QAM, pilot every {PILOT_EVERY}): bit for bit "
          f"with its plain twin {same} (max |diff| {twin_err:.3e} rad), max |phase err| "
          f"{err:.3e} rad against carrier_recovery.ddpll, kernel {ms:.3f} ms "
          f"({ms * 1e-3 / n_pll * sm_mhz * 1e6:.1f} cycles per symbol at {sm_mhz:.0f} MHz), "
          f"plain twin {twin_s * 1e3:.1f} ms, reference rule {rule_s * 1e3:.1f} ms")
    _check(same, "DD-PLL kernel differs from its plain twin")
    _check(err < PLL_ATOL and bool(torch.isfinite(est_k).all()),
           "DD-PLL kernel disagrees with the reference rule")
    report["ddpll"] = _with_cycles(_with_bound(
        dict(max_abs_err=twin_err, ms=ms, plain_ms=twin_s * 1e3, reference_rule_ms=rule_s * 1e3,
             max_abs_err_reference_rule=err),
        *_ddpll_cost(n_pll, 22, int(pilot.sum()))), n_pll, sm_mhz)
    return report


def _scores(y, ref, disc):
    """Per polarization (BER, GMI, EVM) numpy arrays after ``disc`` symbols."""
    from opticommpy_torch.comm.metrics import calc_evm, fast_ber_calc, monte_carlo_gmi

    yy, dd = y[disc:-100], ref[disc:-100]
    ber, _, _ = fast_ber_calc(yy, dd, 16, "qam")
    gmi, _ = monte_carlo_gmi(yy, dd, 16, "qam")
    evm = calc_evm(yy, 16, "qam", symb_tx=dd)
    return tuple(t.cpu().numpy() for t in (ber, gmi, evm))


def _retained(n_samples_in):
    """Symbols clock recovery keeps of an SpS-16 input: int((1 - 500e-6) *
    n_dsp) // 2 (tools/jax_cr_serve_reference.py)."""
    return int((1 - 500e-6) * (-(-n_samples_in // 8))) // 2


def _counts():
    from opticommpy_torch.kernels import (bps, ddpll, dfe, gardner, ldpc, lift, mimo_eq, qc,
                                          qc_mega, rls, unwrap, volterra)

    return dict(bps=bps.launches, unwrap=unwrap.launches, mimo_eq=mimo_eq.launches,
                mimo_eq_batch=mimo_eq.batch_launches, rls=rls.launches,
                rls_batch=rls.batch_launches, gardner=gardner.launches,
                ddpll=ddpll.launches, ldpc_check=ldpc.launches,
                qc_check=qc.check_launches, qc_var=qc.var_launches,
                qc_mega=qc_mega.launches, lift_iter=lift.launches, dfe=dfe.launches,
                volterra=volterra.launches)


def _reset_counts():
    from opticommpy_torch.kernels import (bps, ddpll, dfe, gardner, ldpc, lift, mimo_eq, qc,
                                          qc_mega, rls, unwrap, volterra)

    bps.launches = unwrap.launches = mimo_eq.launches = mimo_eq.batch_launches = 0
    rls.launches = rls.batch_launches = gardner.launches = ddpll.launches = 0
    ldpc.launches = qc.check_launches = qc.var_launches = 0
    qc_mega.launches = lift.launches = dfe.launches = volterra.launches = 0


def _expect(**nonzero):
    out = dict.fromkeys(("bps", "unwrap", "mimo_eq", "mimo_eq_batch", "rls", "rls_batch", "gardner",
                         "ddpll", "ldpc_check", "qc_check", "qc_var", "qc_mega",
                         "lift_iter", "dfe", "volterra"), 0)
    out.update(nonzero)
    return out


def path_a_inputs(res, n_train=12000):
    """(signal at a receiver clock PPM_A fast with sampling jitter, the
    reference trimmed to what clock recovery keeps, the chain's config)."""
    from opticommpy_torch.ops import clock_sampling_interp
    from opticommpy_torch.pipelines import CoherentDSPConfig

    fs = 16 * 32e9
    sig_off = clock_sampling_interp(res["sig_rx"], fs, fs * (1 + PPM_A * 1e-6),
                                    jitter_rms=1e-3 / fs, generator=res["gen"])
    d_cr = res["d_ref"][:_retained(sig_off.shape[0])]
    cfg = CoherentDSPConfig(SpS_in=16, L=250, nTrain=n_train, mu=(5e-3, 2e-3),
                            eqBackend="pallas", cprBackend="pallas", runCR=True,
                            crMethod="gardner", crBackend="pallas", crNyquist=True,
                            crKp=2e-3, crKi=1e-5)
    return sig_off, d_cr, cfg


def run_cr_path_a(dev, res, n_train=12000):
    """Path A: the centre channel at a receiver clock PPM_A fast, Gardner
    clock recovery on K6 in coherent_dsp_chain; the same signal without
    clock recovery as the control."""
    from dataclasses import replace
    from unittest import mock

    from opticommpy_torch.kernels import gardner
    from opticommpy_torch.pipelines import coherent_dsp_chain

    sig_off, d_cr, cfg = path_a_inputs(res, n_train)
    _reset_counts()
    (y, phases), first_s = _wall(lambda: coherent_dsp_chain(sig_off, d_cr, cfg))
    counts = _counts()
    print(f"path A launches: {counts}")
    _check(counts == _expect(gardner=1, mimo_eq=3, bps=1, unwrap=1),
           f"path A: launches {counts}, expected K6 1, K2 3, K1 1")
    _check(tuple(y.shape) == tuple(d_cr.shape) and y.is_cuda and bool(torch.isfinite(y).all()),
           f"path A: unexpected output {tuple(y.shape)}")
    (y2, _), warm_s = _wall(lambda: coherent_dsp_chain(sig_off, d_cr, cfg))
    same = bool(torch.equal(y, y2))
    # K6 against its plain version on the input it got on path A (the
    # chain's post-EDC signal, padded), and its time there
    with mock.patch.object(gardner, "gardner_records", wraps=gardner.gardner_records) as k6:
        coherent_dsp_chain(sig_off, d_cr, cfg)
    args = k6.call_args.args
    eo_k, tv_k, n_k = gardner.gardner_records(*args)
    (eo_p, tv_p, n_p), plain_s = _wall(lambda: gardner.gardner_plain(*args))
    e_err = float((eo_k - eo_p).abs().max())
    t_err = float((tv_k - tv_p).abs().max())
    same_n = bool(torch.equal(n_k, n_p))
    exact = bool(torch.equal(eo_k, eo_p)) and bool(torch.equal(tv_k, tv_p)) and same_n
    ms = _cuda_ms(lambda: gardner.gardner_records(*args), 3)
    sm_mhz = _sm_clock_mhz()
    n_in = args[0].shape[0]
    print(f"K6 gardner on path A's input ({n_in} x 2 samples, nyquist): max |eo err| "
          f"{e_err:.3e}, max |t err| {t_err:.3e}, n_final equal {same_n} {n_k.tolist()}, "
          f"bit for bit {exact}, kernel {ms:.3f} ms ({n_in / ms / 1e3:.3f} Msample/s per "
          f"mode, {ms * 1e-3 / n_in * sm_mhz * 1e6:.1f} cycles per sample at {sm_mhz:.0f} "
          f"MHz), plain {plain_s * 1e3:.1f} ms")
    _check(e_err < CR_ATOL and t_err < CR_ATOL and same_n and exact,
           "Gardner kernel disagrees with plain on path A's input")
    k6_report = dict(max_abs_err=max(e_err, t_err), ms=ms, plain_ms=plain_s * 1e3,
                     cost=_gardner_cost(n_in, args[4], 2, int(n_k.sum())), n_in=n_in,
                     sm_clock_mhz=sm_mhz)
    n_sym = d_cr.shape[0]
    disc = n_train + 2000
    ber, gmi, evm = _scores(y, d_cr, disc)
    y_n, _ = coherent_dsp_chain(sig_off, d_cr, replace(cfg, runCR=False))
    ber_n, gmi_n, _ = _scores(y_n, d_cr, disc)
    print(f"path A ({PPM_A:.0f} ppm, {sig_off.shape[0]} samples, {n_sym} symbols): first "
          f"{first_s:.3f} s, warm {warm_s:.3f} s, {n_sym / warm_s / 1e6:.4f} Msym/s; two runs "
          f"bit-identical: {same}")
    print(f"path A: BER {ber[0]:.3e} {ber[1]:.3e} (JAX {JAX_CR_A['ber'][0]:.3e} "
          f"{JAX_CR_A['ber'][1]:.3e}), GMI {gmi[0]:.4f} {gmi[1]:.4f} (JAX "
          f"{JAX_CR_A['gmi'][0]:.4f} {JAX_CR_A['gmi'][1]:.4f}), EVM {evm[0]:.4f} {evm[1]:.4f}; "
          f"without clock recovery BER {ber_n[0]:.3e} {ber_n[1]:.3e}, GMI {gmi_n[0]:.4f} "
          f"{gmi_n[1]:.4f} (JAX {JAX_CR_A['no_cr_ber'][0]:.3e} {JAX_CR_A['no_cr_ber'][1]:.3e})")
    for p in range(2):
        _check(ber[p] <= 2 * JAX_CR_A["ber"][p] + 1e-4,
               f"path A: BER {ber[p]} above 2 x JAX {JAX_CR_A['ber'][p]} + 1e-4 (pol {p})")
        _check(gmi[p] >= JAX_CR_A["gmi"][p] - 0.05,
               f"path A: GMI {gmi[p]} below JAX {JAX_CR_A['gmi'][p]} - 0.05 (pol {p})")
    return dict(counts=counts, warm_s=warm_s, n_sym=n_sym, k6=k6_report)


def _median_check(name, rows, failures):
    """Print every channel and polarization; hold the medians over them to
    the JAX package's (its realization differs)."""
    jax_ber, jax_gmi = JAX_CR_BC[name]["ber"], JAX_CR_BC[name]["gmi"]
    for k, (ber, gmi, evm) in enumerate(rows):
        print(f"  {name} ch {k:2d}: BER {ber[0]:.3e} {ber[1]:.3e} (JAX {jax_ber[k][0]:.3e} "
              f"{jax_ber[k][1]:.3e}), GMI {gmi[0]:.4f} {gmi[1]:.4f} (JAX {jax_gmi[k][0]:.4f} "
              f"{jax_gmi[k][1]:.4f}), EVM {evm[0]:.4f} {evm[1]:.4f}")
    med_ber = float(np.median([r[0] for r in rows]))
    med_gmi = float(np.median([r[1] for r in rows]))
    j_ber, j_gmi = float(np.median(jax_ber)), float(np.median(jax_gmi))
    n_ok = sum(int(b < 1e-3) for r in rows for b in r[0])
    n_ok_jax = sum(int(b < 1e-3) for r in jax_ber for b in r)
    print(f"{name}: median BER {med_ber:.3e} (JAX {j_ber:.3e}), median GMI {med_gmi:.4f} "
          f"(JAX {j_gmi:.4f}); polarizations with BER < 1e-3: {n_ok} of {2 * len(rows)} "
          f"(JAX {n_ok_jax})")
    if not (med_ber <= 2 * j_ber + 1e-4 and med_gmi >= j_gmi - 0.05):
        failures.append(f"{name}: median BER {med_ber:.3e} GMI {med_gmi:.4f} vs JAX "
                        f"{j_ber:.3e} {j_gmi:.4f}")


def path_b_inputs(res, sig_b, ref_b, n_train=12000):
    """(channel k of ``sig_b`` at a receiver clock PPM_B[k] fast, all cut
    to the shortest; the references trimmed; the batch chain's config)."""
    from opticommpy_torch.ops import clock_sampling_interp
    from opticommpy_torch.pipelines import CoherentDSPConfig

    fs = 16 * 32e9
    offs = [clock_sampling_interp(sig_b[k], fs, fs * (1 + PPM_B[k] * 1e-6),
                                  jitter_rms=1e-3 / fs, generator=res["gen"])
            for k in range(sig_b.shape[0])]
    n = min(o.shape[0] for o in offs)
    cfg = CoherentDSPConfig(SpS_in=16, L=250, nTrain=n_train, mu=(5e-3, 2e-3),
                            eqBackend="pallas", cprBackend="pallas", runCR=True,
                            crMethod="ffw")
    return torch.stack([o[:n] for o in offs]), ref_b[:, :_retained(n)], cfg


def run_cr_path_b(dev, res, sig_b, ref_b, n_train=12000):
    """Path B: channel k of the WDM receiver at its own clock offset PPM_B[k],
    feedforward clock recovery in coherent_dsp_chain_batch (K3, K1; no K6);
    each channel against the same chain on the CPU, the medians against
    the JAX package."""
    from unittest import mock

    from opticommpy_torch import pipelines
    from opticommpy_torch.dsp.clock_recovery import ffw_clock_recovery
    from opticommpy_torch.pipelines import coherent_dsp_chain_batch

    sig_o, ref_o, cfg = path_b_inputs(res, sig_b, ref_b, n_train)
    _reset_counts()
    (y, phases), first_s = _wall(lambda: coherent_dsp_chain_batch(sig_o, ref_o, cfg))
    counts = _counts()
    print(f"path B launches: {counts}")
    _check(counts == _expect(mimo_eq_batch=3, bps=1, unwrap=1),
           f"path B: launches {counts}, expected K3 3, K1 1, K6 0")
    _check(tuple(y.shape) == tuple(ref_o.shape) and bool(torch.isfinite(y).all()),
           f"path B: unexpected output {tuple(y.shape)}")
    (_, _), warm_s = _wall(lambda: coherent_dsp_chain_batch(sig_o, ref_o, cfg))
    n_sym = ref_o.shape[1]
    print(f"path B ({sig_o.shape[0]} channels at {PPM_B[0]:.0f} .. "
          f"{PPM_B[sig_o.shape[0] - 1]:.0f} ppm, {n_sym} symbols): "
          f"first {first_s:.3f} s, warm {warm_s:.3f} s, "
          f"{sig_o.shape[0] * n_sym / warm_s / 1e6:.4f} Msym/s aggregate")
    # the clock estimates, from the signals the chain retimed
    with mock.patch.object(pipelines, "ffw_clock_recovery",
                           wraps=pipelines.ffw_clock_recovery) as ffw:
        coherent_dsp_chain_batch(sig_o, ref_o, cfg)
    ffw_in = [c.args for c in ffw.call_args_list]
    ppm_est = [float(ffw_clock_recovery(*args, return_est=True)[1][0]) for args in ffw_in]
    print("path B clock estimates (ppm): "
          + ", ".join(f"ch {k} {PPM_B[k]:.0f} -> {p:.4f}" for k, p in enumerate(ppm_est)))
    # the same chain on the same input on the CPU (the kernels' plain
    # versions): the per-channel reference
    disc = n_train + 2000
    (y_cpu, _), cpu_s = _wall(lambda: coherent_dsp_chain_batch(sig_o.cpu(), ref_o.cpu(), cfg))
    d = (y.cpu() - y_cpu).abs()
    print(f"path B on the CPU (plain versions): {cpu_s:.1f} s, CUDA vs CPU max |diff| "
          f"{float(d.max()):.3e}, share > 1e-3: {float((d > 1e-3).float().mean()):.2e}")
    failures = []
    rows = [_scores(y[k], ref_o[k], disc) for k in range(y.shape[0])]
    for k, (ber, gmi, _) in enumerate(rows):
        c_ber, c_gmi, _ = _scores(y_cpu[k], ref_o[k].cpu(), disc)
        print(f"  B ffw ch {k:2d}: BER {ber[0]:.3e} {ber[1]:.3e} (CPU {c_ber[0]:.3e} "
              f"{c_ber[1]:.3e}), GMI {gmi[0]:.4f} {gmi[1]:.4f} (CPU {c_gmi[0]:.4f} "
              f"{c_gmi[1]:.4f})")
        for p in range(2):
            if not (ber[p] <= 2 * c_ber[p] + 1e-4 and gmi[p] >= c_gmi[p] - 0.05):
                failures.append(f"B ffw ch {k} pol {p}: BER {ber[p]:.3e} GMI {gmi[p]:.4f} vs "
                                f"CPU {c_ber[p]:.3e} {c_gmi[p]:.4f}")
    _median_check("B ffw", rows, failures)
    return dict(counts=counts, warm_s=warm_s, failures=failures, ppm_est=ppm_est,
                ffw_in=ffw_in)


def serve_inputs(res, n_channels=11):
    """Path C's inputs: every channel with its LO at its grid frequency,
    resampled to 64 GS/s. Returns (signals (B, N, 2), training front end
    pnorm(edc(fir_filter(rrc at SpS 2, x))) (B, N, 2), synchronized
    references, the front end's pnorm scalars (B,), the matched filter, the
    EDC config)."""
    from opticommpy_torch.dsp import EDCConfig, edc
    from opticommpy_torch.models import (LaserConfig, PDMFrontendConfig, basic_laser_model,
                                         pdm_coherent_receiver)
    from opticommpy_torch.models.tx import wdm_freq_grid
    from opticommpy_torch.ops import fir_filter, pnorm, pulse_shape, resample, symbol_sync

    sig_ch, gen = res["sig_ch"], res["gen"]
    fs = 16 * 32e9
    edc_cfg = EDCConfig(L=250, D=16, Fs=64e9, Rs=32e9)
    pulse2 = pulse_shape("rrc", 2, 1024, 0.01).astype(np.float32)
    xs, fronts, scales, refs = [], [], [], []
    for k, f_k in enumerate(wdm_freq_grid(n_channels, 37.5e9)):
        lo = basic_laser_model(LaserConfig(P=10.0, lw=100e3, Ns=sig_ch.shape[0], Fs=fs,
                                           freqShift=float(f_k), RIN_var=0.0), gen)
        sig_rx = pdm_coherent_receiver(sig_ch, lo, PDMFrontendConfig(Fs=fs), generator=gen)
        x = resample(sig_rx, fs, 64e9)
        pre = edc(fir_filter(pulse2, x), edc_cfg)
        s = torch.sqrt(torch.mean((pre * pre.conj()).real))
        refs.append(pnorm(symbol_sync(pre, res["symb_tx"][:, :, k], 2)))
        xs.append(x)
        fronts.append(pre / s)
        scales.append(s)
    return (torch.stack(xs), torch.stack(fronts), torch.stack(refs), torch.stack(scales),
            pulse2, edc_cfg)


def run_serve_path_c(dev, res, n_train=12000, n_channels=11):
    """Path C: every channel with its LO at its grid frequency, resampled to
    64 GS/s; taps trained by mimo_adapt_equalizer_batch (K3) on the serving
    front end, then coherent_dsp_serve (K1) and the DD-PLL (K7) over the 22
    columns of the served symbols."""
    from opticommpy_torch.dsp import (CPRConfig, MIMOEqualizerConfig, cpr, edc,
                                      mimo_adapt_equalizer_batch)
    from opticommpy_torch.dsp.carrier_recovery import unwrap
    from opticommpy_torch.dsp.equalization import mimo_apply, mimo_apply_fused
    from opticommpy_torch.kernels.bps import bps_kernel
    from opticommpy_torch.ops import fir_filter
    from opticommpy_torch.comm.modulation import norm_const
    from opticommpy_torch.pipelines import CoherentDSPConfig, coherent_dsp_serve

    t0 = time.perf_counter()
    x_b, front_b, ref_b, scale_b, pulse2, edc_cfg = serve_inputs(res, n_channels)
    torch.cuda.synchronize()
    rx_s = time.perf_counter() - t0
    n_sym = ref_b.shape[1]
    eq_cfg = MIMOEqualizerConfig(nTaps=15, SpS=2, mu=(5e-3, 2e-3), alg=("da-rde", "dd-lms"),
                                 L=(n_train, n_sym - n_train), M=16, numIter=2,
                                 backend="pallas")
    _reset_counts()
    (_, H_b, _), train_s = _wall(lambda: mimo_adapt_equalizer_batch(
        front_b, eq_cfg, symb_ref=ref_b, return_results=True))
    train_counts = _counts()
    print(f"path C: receive + resample {rx_s:.3f} s; training launches {train_counts}, "
          f"{train_s:.3f} s")
    _check(train_counts == _expect(mimo_eq_batch=3), f"path C training: {train_counts}")

    cfg = CoherentDSPConfig(SpS_in=16, L=250, nTrain=n_train, mu=(5e-3, 2e-3))
    _reset_counts()
    (out, phases), serve_first_s = _wall(lambda: coherent_dsp_serve(x_b, H_b, cfg, scale_b))
    serve_counts = _counts()
    print(f"path C serve launches: {serve_counts}")
    _check(serve_counts == _expect(bps=1, unwrap=1),
           f"path C serve: {serve_counts}, expected K1 1, K15 1")
    n_cols = 2 * n_channels
    _check(tuple(out.shape) == (n_channels, n_sym, 2) and tuple(phases.shape) == (n_sym, n_cols)
           and bool(torch.isfinite(out).all()), f"path C serve: output {tuple(out.shape)}")
    (out2, _), serve_s = _wall(lambda: coherent_dsp_serve(x_b, H_b, cfg, scale_b))
    same = bool(torch.equal(out, out2))
    print(f"path C serve: first {serve_first_s:.3f} s, warm {serve_s:.3f} s, "
          f"{n_channels * n_sym / serve_s / 1e6:.4f} Msym/s aggregate ({n_channels} x {n_sym} "
          f"symbols); two "
          f"runs bit-identical: {same}")
    # the staged composition on the card: fir_filter, edc, pnorm, mimo_apply,
    # BPS on K1 (one launch per channel), unwrap, derotation
    rel = []
    for k in sorted({0, n_channels // 2, n_channels - 1}):
        y_k = mimo_apply(H_b[k], edc(fir_filter(pulse2, x_b[k]), edc_cfg) / scale_b[k], 2)
        ph = unwrap(4 * bps_kernel(y_k, 37, norm_const(16, "qam"), 64), dim=0) / 4
        ref_k = (y_k * torch.exp(1j * ph))[32:n_sym - 612]
        rel.append(float(torch.linalg.norm(out[k, 32:n_sym - 612] - ref_k)
                         / torch.linalg.norm(ref_k)))
    print(f"path C serve vs the staged mimo_apply + BPS composition (first, centre, last): "
          f"relative error {', '.join(f'{v:.3e}' for v in rel)}")
    _check(max(rel) < SERVE_REL, f"path C serve disagrees with the staged composition: {rel}")

    y_cols = torch.stack([mimo_apply_fused(H_b[k], x_b[k], 2, pre=pulse2, edc_config=edc_cfg,
                                           scale=scale_b[k]) for k in range(n_channels)],
                         dim=1).reshape(n_sym, n_cols)
    r_cols = ref_b.transpose(0, 1).reshape(n_sym, n_cols)
    cpr_cfg = CPRConfig(alg="ddpll-pallas", M=16, Ts=1 / 32e9, runFOE=False)
    pilots = np.arange(0, n_sym, PILOT_EVERY)
    _reset_counts()
    pll, pll_s = _wall(lambda: cpr(y_cols, cpr_cfg, symb_tx=r_cols, pilot_ind=pilots))
    pll_counts = _counts()
    print(f"path C DD-PLL launches: {pll_counts}, {pll_s:.3f} s for {n_cols} x {n_sym} symbols")
    _check(pll_counts == _expect(ddpll=1, unwrap=1),
           f"path C DD-PLL: {pll_counts}, expected K7 1, K15 1")
    pll = pll.reshape(n_sym, n_channels, 2).transpose(0, 1)
    failures = []
    disc = n_train + 2000
    _median_check("C serve", [_scores(out[k], ref_b[k], disc) for k in range(n_channels)],
                  failures)
    _median_check("C ddpll", [_scores(pll[k], ref_b[k], disc) for k in range(n_channels)],
                  failures)
    return dict(train_counts=train_counts, serve_counts=serve_counts, pll_counts=pll_counts,
                serve_s=serve_s, train_s=train_s, pll_s=pll_s, failures=failures,
                train_in=(front_b, ref_b, eq_cfg))


def _msize(mdt):
    return 2 if mdt == "bf16" else 4


def _k8_cost(D, n, mdt):
    """(bytes, flops) of K8 on (D, n): each message read and written once;
    ~6 operations per message (two mins, the sign, the scale)."""
    return 2 * D * n * _msize(mdt), 6 * D * n


def _k9_cost(tb, B, mdt):
    """(bytes, flops) of K9: M read and written once, the totals T and Tp
    read once (in the message type), the vote written; ~12 operations per
    message (subtract, round, two-min update, parities, leave-one-out)."""
    D, q, G = tb["S"] + 2, tb["q"], tb["G"]
    ms = _msize(mdt)
    return 2 * D * q * 360 * B * ms + (G + q) * 360 * B * ms + 4 * B, 12 * D * q * 360 * B


def _k10_cost(tb, B, mdt, n_frozen):
    """(bytes, flops) of K10: the info messages and the LLRs read once, the
    old frozen totals read for the ``n_frozen`` frozen codewords only, T and
    the frozen totals (float32) and at bfloat16 the copy written once, the
    freeze flags read; one add per message."""
    S, q, G = tb["S"], tb["q"], tb["G"]
    ms = _msize(mdt)
    copy = ms if mdt == "bf16" else 0
    return (S * q * 360 * B * ms + G * 360 * B * (4 + 4 + 4 + copy) + G * 360 * n_frozen * 4
            + B), S * q * 360 * B


def _k11_steps(n_iters, done, K, early_exit, schedule):
    """What K11 runs, summed over the codewords: (full steps, steps of the
    check columns only, how many of those write their messages).

    Flooding: a codeword runs full steps (check columns, then totals) until
    its vote latches at step n_iters, then stops after that step's check
    columns (early exit), whose messages are written; otherwise it runs
    K - 1 full steps and the phantom last step, which only votes. Layered:
    every sweep is full; a converged codeword stops after sweep n_iters with
    early exit (n_iters + 1 sweeps), otherwise it runs K."""
    B = n_iters.numel()
    if schedule == "layered":
        if not early_exit:
            return K * B, 0, 0
        run = torch.where(done.bool(), n_iters + 1, torch.full_like(n_iters, K))
        return int(torch.clamp(run, max=K).sum()), 0, 0
    if not early_exit:
        return (K - 1) * B, B, 0
    stop = done.bool() & (n_iters < K - 1)
    full = torch.where(stop, n_iters, torch.full_like(n_iters, K - 1))
    return int(full.sum()), B, int(stop.sum())


def _k11_cost(tb, mdt, steps, B, schedule="flooding"):
    """(bytes, flops) of K11 over the codeword-steps ``steps``
    (:func:`_k11_steps`). A full step reads and writes the messages once
    (they do not fit on chip: 466 KB per R4/5 codeword in bf16 against
    227 KB of shared memory), except at step 0, where none are read yet,
    and reads and writes the totals once (flooding: in the message type,
    with the LLRs read again; layered: float32 in place). A step of the
    check columns only reads the totals and the messages, and writes the
    messages unless it is the phantom step. The LLRs are read and the
    float32 outputs written once per codeword. ~12 operations per message
    on the check side (K9's count) and one add per message on the variable
    side."""
    full, check_only, writes = steps
    D, q, G = tb["S"] + 2, tb["q"], tb["G"]
    ms = _msize(mdt)
    per_cw = (G + q) * 360
    msg = D * q * 360 * ms
    tot = per_cw * (2 * ms + 4) if schedule == "flooding" else per_cw * 8
    nbytes = (full * (2 * msg + tot) - B * msg + check_only * (msg + per_cw * ms)
              + writes * msg + B * per_cw * 8 + 8 * B)
    return nbytes, (13 * full + 12 * check_only) * D * q * 360


def _k12_cost(tb, B, mdt):
    """(bytes, flops) of one K12 iteration: X read and X' written (message
    type), the LLRs read and T written (float32), the flags written;
    ~10 operations per message (two-min, sign, scale, the totals' add, the
    rounding and subtraction of X')."""
    E, L, V = tb["E"], tb["L"], tb["V"]
    return 2 * E * L * B * _msize(mdt) + 2 * V * L * B * 4 + 4 * B, 10 * E * L * B


def _zero_codeword_llrs(dev, n, B, lo_db, hi_db, seed):
    """BPSK/AWGN LLRs (n, B) float32 of the all-zero codeword (a codeword of
    every linear code) on ``dev``, column b at Es/N0 from ``lo_db`` to
    ``hi_db`` [dB]."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    snr = torch.linspace(lo_db, hi_db, B, device=dev)
    sigma = torch.sqrt(0.5 * 10 ** (-snr / 10))
    return 2 * (1 + sigma * torch.randn((n, B), generator=gen, device=dev)) / sigma**2


def _path_e_llrs(dev, B=512, seed=5, esn0_db=2.3):
    """Path E's input, drawn on the card: B encoded DVB-S2 64800 R4/5
    codewords, BPSK over AWGN at Es/N0 ``esn0_db`` (bench_fec.py:135-171,
    with encoded codewords). Returns (graph, codewords (64800, B) int8,
    LLRs (64800, B) float32)."""
    from opticommpy_torch.comm.fec import encode_ldpc, standard_ldpc

    graph, edges = standard_ldpc("DVBS2", 64800, "4/5")
    gen = torch.Generator(device=dev).manual_seed(seed)
    info = torch.randint(0, 2, (64800 - 12960, B), generator=gen, device=dev,
                         dtype=torch.int32)
    cw = encode_ldpc(info, edges=edges)
    sigma = float(np.sqrt(0.5 * 10 ** (-esn0_db / 10)))
    y = (1 - 2 * cw.float()) + sigma * torch.randn(cw.shape, generator=gen, device=dev)
    return graph, cw, 2 * y / sigma**2


def _fused_state(tb, llr, mdt, steps=3):
    """The fused decoder's state after ``steps`` steps (NMSA) of ``llr`` on
    the kernels' plain versions: (layout, Tc, Tpc, M, llr_info, fT,
    freeze)."""
    from opticommpy_torch.comm import fec_qc
    from opticommpy_torch.kernels import qc

    lay = qc.QCLayout(tb, llr.device)
    llr_info, llr_p, c = fec_qc.fused_init(tb, llr, mdt)
    for kk in range(steps):
        fec_qc.fused_step(c, llr_info, llr_p, lay, 0.75, kk, 21, plain=True)
    return lay, c["Tc"], c["Tpc"], c["M"], llr_info, c["fT"], c["done"].clone()


def phase_ldpc_kernels(dev, llr):
    """K8, K9 and K10 against their plain versions on the card, each timed
    with CUDA events: K8 at (18, 36, 360, 512); K9 and K10 on the state after
    three plain fused steps of path E's LLRs at R4/5, R9/10 and R1/4; both
    message types. Every comparison must be exact."""
    from opticommpy_torch.comm import fec_qc
    from opticommpy_torch.kernels import ldpc, qc

    report = {}
    B = llr.shape[1]
    gen = torch.Generator(device=dev).manual_seed(8)
    x32 = torch.randn((18, 36, 360, B), generator=gen, device=dev)
    x32[:, 0, :4] = 0.0  # zeros
    x32[3:6, 1, 7] = -0.5  # tied minima
    x32[17, 0, 0] = float("inf")  # the masked staircase entry of check 0
    worst = 0.0
    for mdt in ("bf16", "f32"):
        x = x32.to(torch.bfloat16 if mdt == "bf16" else torch.float32)
        for alpha in (None, 0.75):
            out_k = ldpc.check_update_msa(x, alpha)
            out_p = ldpc.check_update_msa_plain(x, alpha)
            torch.cuda.synchronize()
            err = float((out_k.float() - out_p.float()).abs().max())
            same = bool(torch.equal(out_k, out_p))
            ms = _cuda_ms(lambda: ldpc.check_update_msa(x, alpha), 20)
            plain_ms = _cuda_ms(lambda: ldpc.check_update_msa_plain(x, alpha), 3)
            bound = _bound(*_k8_cost(18, 36 * 360 * B, mdt))
            print(f"K8 ldpc_check {mdt} alpha {alpha} (18, 36, 360, {B}): max |err| {err:.1e}, "
                  f"bit-identical {same}, kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
                  f"{bound[0]:.4f} ms ({bound[1]})")
            _check(same and err == 0.0, f"K8 disagrees with plain ({mdt}, alpha {alpha})")
            worst = max(worst, err)
            if mdt == "bf16" and alpha == 0.75:
                report["ldpc_check"] = _with_bound(dict(ms=ms, plain_ms=plain_ms),
                                                   *_k8_cost(18, 36 * 360 * B, mdt))
    report["ldpc_check"]["max_abs_err"] = worst

    worst9 = worst10 = 0.0
    for R in ("4/5", "9/10", "1/4"):
        tb = fec_qc.qc_tables(R, 64800)
        for mdt in ("bf16", "f32"):
            lay, Tc, Tpc, M, llr_info, fT, freeze = _fused_state(tb, llr, mdt)
            freeze[::3] = True  # the frozen-output select on a third of the codewords
            bf16 = mdt == "bf16"
            M_k, ok_k = qc.check_column_update(Tc, Tpc, M, lay, 0.75)
            M_p, ok_p = qc.check_column_plain(Tc, Tpc, M, lay, 0.75)
            v_k = qc.var_totals_update(M_k, llr_info, fT, freeze, lay, msg_copy=bf16)
            v_p = qc.var_totals_plain(M_k, llr_info, fT, freeze, lay, msg_copy=bf16)
            torch.cuda.synchronize()
            e9 = max(float((M_k.float() - M_p.float()).abs().max()),
                     float((ok_k != ok_p).sum()))
            e10 = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(v_k, v_p) if a is not None)
            same9 = bool(torch.equal(M_k, M_p)) and bool(torch.equal(ok_k, ok_p))
            same10 = all(a is None and b is None or bool(torch.equal(a, b))
                         for a, b in zip(v_k, v_p))
            ms9 = _cuda_ms(lambda: qc.check_column_update(Tc, Tpc, M, lay, 0.75), 20)
            plain9 = _cuda_ms(lambda: qc.check_column_plain(Tc, Tpc, M, lay, 0.75), 2)
            ms10 = _cuda_ms(lambda: qc.var_totals_update(M_k, llr_info, fT, freeze, lay,
                                                         msg_copy=bf16), 20)
            plain10 = _cuda_ms(lambda: qc.var_totals_plain(M_k, llr_info, fT, freeze, lay,
                                                           msg_copy=bf16), 2)
            n_frozen = int(freeze.sum())
            b9 = _bound(*_k9_cost(tb, B, mdt))
            b10 = _bound(*_k10_cost(tb, B, mdt, n_frozen))
            print(f"K9 qc_check R{R} {mdt} (D={tb['S'] + 2}, q={tb['q']}, B={B}, votes "
                  f"{int(ok_k.sum())}): max |err| {e9:.1e}, bit-identical {same9}, kernel "
                  f"{ms9:.4f} ms, plain {plain9:.2f} ms, bound {b9[0]:.4f} ms ({b9[1]})")
            print(f"K10 qc_var R{R} {mdt} (G={tb['G']}, B={B}, frozen {n_frozen}): "
                  f"max |err| {e10:.1e}, bit-identical {same10}, kernel {ms10:.4f} ms, plain "
                  f"{plain10:.2f} ms, bound {b10[0]:.4f} ms ({b10[1]})")
            _check(same9 and e9 == 0.0, f"K9 disagrees with plain (R{R}, {mdt})")
            _check(same10 and e10 == 0.0, f"K10 disagrees with plain (R{R}, {mdt})")
            worst9, worst10 = max(worst9, e9), max(worst10, e10)
            if R == "4/5" and mdt == "f32":  # the type path E decodes with on K9/K10
                report["qc_check"] = _with_bound(dict(ms=ms9, plain_ms=plain9),
                                                 *_k9_cost(tb, B, mdt))
                report["qc_var"] = _with_bound(dict(ms=ms10, plain_ms=plain10),
                                               *_k10_cost(tb, B, mdt, n_frozen))
            del lay, Tc, Tpc, M, M_k, M_p, v_k, v_p
    report["qc_check"]["max_abs_err"] = worst9
    report["qc_var"]["max_abs_err"] = worst10
    return report


def phase_mega_lift_kernels(dev, llr, lift_B=1024):
    """K11 and K12 against their plain versions on the card, each timed with
    CUDA events. K11 (NMSA-20, B = 512) on path E's LLRs at R4/5 and on
    all-zero codewords near each code's waterfall at R9/10 and R1/4: the
    flooding schedule at bf16 and f32, against the fused route (K9 + K10)
    and ``mega_decode_plain``; the layered schedule at the three rates; early
    exit against the fixed loop. K12 (NMSA) at AR4JA 8192 R1/2, B = 1024,
    and at 802.11n 1944 R1/2 (L = 81), on the state after two plain
    iterations. Every comparison must be exact."""
    from opticommpy_torch.comm import fec_lift, fec_qc
    from opticommpy_torch.kernels import lift, qc, qc_mega

    report = {}
    B = llr.shape[1]
    inputs = {"4/5": llr,
              "9/10": _zero_codeword_llrs(dev, 64800, B, 4.4, 6.0, 9),
              "1/4": _zero_codeword_llrs(dev, 64800, B, -2.9, -1.6, 10)}
    worst = 0.0
    for R, x in inputs.items():
        tb = fec_qc.qc_tables(R, 64800)
        lay = qc.QCLayout(tb, dev)
        li, lp = fec_qc._split_llrs(tb, x)
        schedules = ("flooding", "layered")
        for mdt in ("bf16", "f32"):
            fused = fec_qc.make_qc_decoder(64800, R, 20, "NMSA", mdt, backend="fused")(x)
            for sched in schedules:
                runs = {}
                for ee in (False, True):
                    k = qc_mega.qc_decode_mega(li, lp, lay, 21, 0.75, mdt, ee, sched)
                    p, plain_s = _wall(lambda: fec_qc.mega_decode_plain(li, lp, lay, 21, 0.75,
                                                                        mdt, ee, sched))
                    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(k, p))
                    same = all(bool(torch.equal(a, b)) for a, b in zip(k, p))
                    ms = _cuda_ms(lambda: qc_mega.qc_decode_mega(li, lp, lay, 21, 0.75, mdt, ee,
                                                                 sched), 3)
                    steps = _k11_steps(k[3], k[2], 21, ee, sched)
                    bound = _bound(*_k11_cost(tb, mdt, steps, B, sched))
                    print(f"K11 qc_mega R{R} {mdt} {sched} {'early exit' if ee else 'fixed-20'} "
                          f"(B={B}): iterations mean {float(k[3].float().mean()):.2f} max "
                          f"{int(k[3].max())}, done {int(k[2].sum())}, max |err| {err:.1e}, "
                          f"bit-identical {same}, kernel {ms:.3f} ms, plain {plain_s * 1e3:.0f} "
                          f"ms, bound {bound[0]:.3f} ms ({bound[1]}; codeword-steps full, "
                          f"check only, check only writing: {steps})")
                    _check(same and err == 0.0, f"K11 disagrees with plain (R{R}, {mdt}, {sched}, "
                           f"early exit {ee})")
                    worst = max(worst, err)
                    runs[ee] = k
                    if R == "4/5" and mdt == "bf16" and sched == "flooding" and ee:
                        # the configuration paths D and E serve with
                        report["qc_mega"] = _with_bound(dict(ms=ms, plain_ms=plain_s * 1e3),
                                                        *_k11_cost(tb, mdt, steps, B, sched))
                same = all(bool(torch.equal(a, b)) for a, b in zip(runs[False], runs[True]))
                _check(same, f"K11 R{R} {mdt} {sched}: early exit differs from the fixed loop")
                if sched == "flooding":
                    mega = fec_qc._outputs(tb, runs[False][0], runs[False][1], runs[False][3],
                                           runs[False][2])
                    same = all(bool(torch.equal(a, b)) for a, b in zip(mega, fused))
                    print(f"K11 R{R} {mdt} flooding: early exit bit-identical to fixed; equal to "
                          f"the fused route (K9 + K10) bit for bit: {same}")
                    _check(same, f"K11 R{R} {mdt}: flooding differs from the fused route")
            del fused
        del lay, li, lp
    report["qc_mega"]["max_abs_err"] = worst
    del inputs

    worst = 0.0
    for mode, n, R in (("AR4JA", 8192, "1/2"), ("IEEE_802.11nD2", 1944, "1/2")):
        B = lift_B
        tb = fec_lift.lift_tables(mode, n, R)
        lay = lift.LiftLayout(tb, dev)
        V, L = tb["V"], tb["L"]
        order = torch.as_tensor(tb["var_order"], dtype=torch.long, device=dev)
        llr_bo = _path_g_llrs(dev, V * L, B).reshape(V, L, B)[order]
        for mdt, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            X = torch.cat([torch.stack([torch.roll(llr_bo[ev[sl, ig]], int(esh[sl, ig]), 0)
                                        for sl in range(d) for ig in range(ng)])
                           for (d, ng), ev, esh in zip(tb["chk_buckets"], tb["ev"], tb["esh"])])
            X = X.to(dt)
            for _ in range(2):
                X = lift.lift_iter_plain(X, llr_bo, lay, 0.75)[0]
            k = lift.lift_iter(X, llr_bo, lay, 0.75)
            p, plain_s = _wall(lambda: lift.lift_iter_plain(X, llr_bo, lay, 0.75))
            err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(k, p))
            same = all(bool(torch.equal(a, b)) for a, b in zip(k, p))
            ms = _cuda_ms(lambda: lift.lift_iter(X, llr_bo, lay, 0.75), 20)
            bound = _bound(*_k12_cost(tb, B, mdt))
            print(f"K12 lift_iter {mode} {n} R{R} {mdt} (L={L}, E={tb['E']}, B={B}, passing "
                  f"{int(k[2].sum())}): max |err| {err:.1e}, bit-identical {same}, kernel "
                  f"{ms:.4f} ms, plain {plain_s * 1e3:.1f} ms, bound {bound[0]:.4f} ms "
                  f"({bound[1]}), {100 * bound[0] / ms:.1f}% of the bound")
            _check(same and err == 0.0, f"K12 disagrees with plain ({mode} {n}, {mdt})")
            worst = max(worst, err)
            if mode == "AR4JA" and mdt == "bf16":  # path G's configuration
                report["lift_iter"] = _with_bound(dict(ms=ms, plain_ms=plain_s * 1e3),
                                                  *_k12_cost(tb, B, mdt))
    report["lift_iter"]["max_abs_err"] = worst
    return report


def _path_g_llrs(dev, n, B, seed=0):
    """Path G's input, drawn on the card: 2.0 + 1.2 N(0, 1) LLRs (n, B), the
    JAX package's ``run_ar4ja_decode`` workload (bench.py:347-365)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return 2.0 + 1.2 * torch.randn((n, B), generator=gen, device=dev)


def run_ldpc_path_e(dev, graph, cw, llr):
    """Path E: decode_ldpc on B=512 encoded R4/5 codewords at 2.3 dB,
    NMSA-20, backend 'auto': float32 and bfloat16 (the serving type)
    messages, each on K11 (fixed, early exit); the same float32 decodes on
    the fused kernels K9/K10 (``backend="fused"``), equal to K11's bit for
    bit (the plain 'xla' route on the card beside them), and the layered
    schedule on K11 with early exit."""
    from opticommpy_torch.comm import fec_qc
    from opticommpy_torch.comm.fec import LDPCConfig, decode_ldpc

    B = llr.shape[1]
    out = {}
    for mdt in ("f32", "bf16"):
        runs = {}
        for ee in (False, True):
            cfg = LDPCConfig(maxIter=20, alg="NMSA", msgDtype=mdt, earlyExit=ee)
            _reset_counts()
            (dec, tot, fail), first_s = _wall(lambda: decode_ldpc(llr, graph=graph, config=cfg))
            counts = _counts()
            _, n_iters, _ = fec_qc.make_qc_decoder(64800, "4/5", 20, "NMSA", mdt, ee)(llr)
            _check(counts == _expect(qc_mega=1), f"path E {mdt} early exit {ee}: launches "
                   f"{counts}, expected K11 1")
            ms = _cuda_ms(lambda: decode_ldpc(llr, graph=graph, config=cfg), 3)
            n_fail, n_err = int(fail.sum()), int((dec != cw).sum())
            print(f"path E decode_ldpc {mdt} {'early exit' if ee else 'fixed-20'} (R4/5, B={B}, "
                  f"2.3 dB): launches K11 {counts['qc_mega']}, iterations mean "
                  f"{float(n_iters.float().mean()):.2f} max {int(n_iters.max())}, frames failed "
                  f"{n_fail}, bit errors {n_err}, first {first_s * 1e3:.1f} ms, warm {ms:.2f} ms, "
                  f"{64800 * B / ms / 1e3:.1f} Mbit/s (codeword bits)")
            _check(n_fail == 0 and n_err == 0, f"path E {mdt}: FER {n_fail}/{B}, {n_err} "
                   "bit errors")
            runs[ee] = (dec, tot, fail, n_iters, ms, counts)
        same = all(bool(torch.equal(a, b)) for a, b in zip(runs[False][:4], runs[True][:4]))
        print(f"path E {mdt}: early exit bit-identical to the fixed loop: {same}")
        _check(same, f"path E {mdt}: early exit differs from the fixed loop")
        out[mdt] = runs
    # the float32 decodes on the fused route (K9 + K10), equal to K11's
    fused = {}
    for ee in (False, True):
        dec_f = fec_qc.make_qc_decoder(64800, "4/5", 20, "NMSA", "f32", ee, backend="fused")
        _reset_counts()
        (tot_f, it_f, fail_f), first_s = _wall(lambda: dec_f(llr))
        counts = _counts()
        steps = 21 if not ee else int(it_f.max()) + 1
        _check(counts == _expect(qc_check=steps, qc_var=steps), f"path E f32 fused early exit "
               f"{ee}: launches {counts}, expected K9 = K10 = {steps}")
        ms = _cuda_ms(lambda: dec_f(llr), 3)
        dec, tot, fail, n_iters = out["f32"][ee][:4]
        same = (bool(torch.equal(tot_f, tot)) and bool(torch.equal(it_f, n_iters))
                and bool(torch.equal(fail_f.to(torch.int8), fail)))
        print(f"path E f32 fused {'early exit' if ee else 'fixed-20'}: launches K9 "
              f"{counts['qc_check']} K10 {counts['qc_var']}, first {first_s * 1e3:.1f} ms, warm "
              f"{ms:.2f} ms ({64800 * B / ms / 1e3:.1f} Mbit/s); K11's 'auto' decode equal to it "
              f"bit for bit: {same}")
        _check(same, f"path E f32 early exit {ee}: K11 differs from the fused route")
        fused[ee] = (ms, counts)
    # the layered schedule on K11 (bf16, early exit)
    cfg = LDPCConfig(maxIter=20, alg="NMSA", msgDtype="bf16", earlyExit=True, schedule="layered")
    _reset_counts()
    (dec, _, fail), first_s = _wall(lambda: decode_ldpc(llr, graph=graph, config=cfg))
    counts = _counts()
    _check(counts == _expect(qc_mega=1), f"path E layered: launches {counts}, expected K11 1")
    _, it_l, _ = fec_qc.make_qc_decoder(64800, "4/5", 20, "NMSA", "bf16", True,
                                        schedule="layered")(llr)
    ms_l = _cuda_ms(lambda: decode_ldpc(llr, graph=graph, config=cfg), 3)
    n_fail, n_err = int(fail.sum()), int((dec != cw).sum())
    mean_l = float(it_l.float().mean())
    mean_f = float(out["bf16"][True][3].float().mean())
    print(f"path E decode_ldpc bf16 layered early exit (R4/5, B={B}, 2.3 dB): launches K11 "
          f"{counts['qc_mega']}, iterations mean {mean_l:.2f} max {int(it_l.max())} (flooding "
          f"{mean_f:.2f}, ratio {mean_l / mean_f:.3f}), frames failed {n_fail}, bit errors "
          f"{n_err}, first {first_s * 1e3:.1f} ms, warm {ms_l:.2f} ms, "
          f"{64800 * B / ms_l / 1e3:.1f} Mbit/s (codeword bits)")
    _check(n_fail == 0 and n_err == 0, f"path E layered: FER {n_fail}/{B}, {n_err} bit errors")
    _check(mean_l < 0.75 * mean_f, f"path E layered: mean iterations {mean_l:.2f} not below "
           f"0.75 x flooding's {mean_f:.2f}")
    # the plain roll route ('xla') on the card, float32
    (tot_x, it_x, fail_x), xla_s = _wall(
        lambda: fec_qc.make_qc_decoder(64800, "4/5", 20, "NMSA", "f32", backend="xla")(llr))
    dec_x = (tot_x < 0).to(torch.int8)
    dec, tot, fail, n_iters = out["f32"][False][:4]
    rel = float((tot - tot_x).abs().max() / tot_x.abs().max())
    it_diff = int((n_iters != it_x).sum())
    dec_diff = int((dec != dec_x).sum())
    print(f"path E f32 (K11, = fused) vs the plain 'xla' route ({xla_s * 1e3:.0f} ms): "
          f"iteration mismatches {it_diff}, decision mismatches {dec_diff}, fail "
          f"mismatches {int((fail.bool() != fail_x).sum())}, totals rel err {rel:.3e}; "
          f"'xla' frames failed {int(fail_x.sum())}, bit errors {int((dec_x != cw).sum())}")
    _check(int(fail_x.sum()) == 0 and bool(torch.equal(dec_x, cw)),
           "path E f32: the plain route does not decode every frame")
    _check(it_diff == 0 and dec_diff == 0 and rel < 1e-5,
           "path E f32: the fused route disagrees with the plain route")
    return dict(fixed_ms=fused[False][0], early_ms=fused[True][0], counts=fused[False][1],
                f32_k11_fixed_ms=out["f32"][False][4], f32_k11_early_ms=out["f32"][True][4],
                bf16_fixed_ms=out["bf16"][False][4], bf16_early_ms=out["bf16"][True][4],
                layered_ms=ms_l)


def run_ldpc_path_f(dev, graph, cw, llr):
    """Path F: make_qc_decoder(backend="pallas") with K8 as the check
    update, bf16 NMSA-20 on path E's LLRs; the same as the bf16 'xla'
    route on the card bit for bit."""
    from opticommpy_torch.comm import fec_qc

    xla_bf16 = fec_qc.make_qc_decoder(64800, "4/5", 20, "NMSA", "bf16", backend="xla")(llr)
    dec_fn = fec_qc.make_qc_decoder(64800, "4/5", 20, "NMSA", "bf16", backend="pallas")
    _reset_counts()
    (tot, n_iters, fail), first_s = _wall(lambda: dec_fn(llr))
    counts = _counts()
    _check(counts == _expect(ldpc_check=20), f"path F: launches {counts}, expected K8 20")
    ms = _cuda_ms(lambda: dec_fn(llr), 2)
    tot_x, it_x, fail_x = xla_bf16
    same = (bool(torch.equal(tot, tot_x)) and bool(torch.equal(n_iters, it_x))
            and bool(torch.equal(fail, fail_x)))
    dec = (tot < 0).to(torch.int8)
    print(f"path F (backend='pallas', bf16 NMSA-20, B={llr.shape[1]}): launches K8 "
          f"{counts['ldpc_check']}, first {first_s * 1e3:.0f} ms, warm {ms:.1f} ms; equal to the "
          f"'xla' route bit for bit: {same}; bit errors {int((dec != cw).sum())}")
    _check(same and bool(torch.equal(dec, (tot_x < 0).to(torch.int8))),
           "path F: the K8 route disagrees with the 'xla' route")
    return dict(counts=counts, ms=ms)


def run_lift_path_g(dev, B=1024):
    """Path G: AR4JA 8192 R1/2 (n = 10,240 with the punctured tail), NMSA-20
    bf16, B = 1024, through decode_ldpc on 'auto', which is K12 (the JAX
    package's ``ar4ja_decode_info_Mbit_per_s_b1024`` workload,
    bench.py:347-365); then the same at f32, and 802.11n 1944 R1/2 (L = 81)
    at B = 1024 bf16, both on K12 too. Each decode launches K12 20 times and
    equals the plain 'xla' lift route on the card in decisions, iterations
    and fail flags."""
    from opticommpy_torch.comm import fec_lift
    from opticommpy_torch.comm.fec import LDPCConfig, decode_ldpc, standard_ldpc

    def held(label, graph, llr, mode, n, R, mdt):
        cfg = LDPCConfig(maxIter=20, alg="NMSA", msgDtype=mdt)
        _reset_counts()
        (dec, tot, fail), first_s = _wall(lambda: decode_ldpc(llr, graph=graph, config=cfg))
        counts = _counts()
        _check(counts == _expect(lift_iter=20), f"path G {label}: launches {counts}, "
               "expected K12 20")
        ms = _cuda_ms(lambda: decode_ldpc(llr, graph=graph, config=cfg), 3)
        llr_n = torch.nn.functional.pad(llr, (0, 0, 0, graph["n"] - llr.shape[0]))
        k12 = fec_lift.make_lift_decoder(mode, n, R, 20, "NMSA", mdt)(llr_n)
        (tot_x, it_x, fail_x), xla_s = _wall(lambda: fec_lift.make_lift_decoder(
            mode, n, R, 20, "NMSA", mdt, backend="xla")(llr_n))
        n_out = tot.shape[0]
        same_dec = bool(torch.equal(dec, (tot_x[:n_out] < 0).to(torch.int8)))
        same_it = bool(torch.equal(k12[1], it_x))
        same_fail = bool(torch.equal(fail, fail_x.to(torch.int8)))
        same_tot = bool(torch.equal(tot, tot_x[:n_out]))
        info_mbps = n * float(Fraction(R)) * B / ms / 1e3
        print(f"path G {label} NMSA-20 (B={B}): launches K12 {counts['lift_iter']}, "
              f"iterations mean {float(k12[1].float().mean()):.2f} max {int(k12[1].max())}, "
              f"frames failed {int(fail.sum())}, ones decided {int(dec.sum())}, first "
              f"{first_s * 1e3:.1f} ms, warm {ms:.2f} ms, {info_mbps:.1f} Mbit/s (info bits); "
              f"the plain 'xla' route on the card ({xla_s * 1e3:.0f} ms): decisions equal "
              f"{same_dec}, iterations equal {same_it}, fail flags equal {same_fail}, totals "
              f"bit-identical {same_tot}")
        _check(same_dec and same_it and same_fail,
               f"path G {label}: K12 disagrees with the 'xla' route")
        _check(bool(torch.isfinite(tot).all()) and tot.shape == llr.shape,
               f"path G {label}: output {tuple(tot.shape)}")
        return dict(counts=counts, ms=ms, info_mbps=info_mbps, failed=int(fail.sum()))

    graph, _ = standard_ldpc("AR4JA", 8192, "1/2")
    llr = _path_g_llrs(dev, graph["n"], B)
    out = held("AR4JA 8192 R1/2 bf16", graph, llr, "AR4JA", 8192, "1/2", "bf16")
    out["f32"] = held("AR4JA 8192 R1/2 f32", graph, llr, "AR4JA", 8192, "1/2", "f32")
    g80211, _ = standard_ldpc("IEEE_802.11nD2", 1944, "1/2")
    llr80211 = _zero_codeword_llrs(dev, 1944, B, -1.5, 0.0, 11)
    out["80211n"] = held("802.11n 1944 R1/2 bf16 (all-zero codewords at -1.5 to 0 dB)",
                         g80211, llr80211, "IEEE_802.11nD2", 1944, "1/2", "bf16")
    _check(out["80211n"]["failed"] < B // 2,
           f"path G 802.11n: {out['80211n']['failed']} of {B} frames failed")
    return out


def _sync_delay(ref, tx):
    """Circular delay d with ref[n] ~ tx[n - d] (one mode), from the peak of
    their cross-correlation."""
    c = torch.fft.ifft(torch.fft.fft(ref) * torch.fft.fft(tx).conj())
    return int(torch.argmax(c.abs()))


def _clean_codewords(n_cw=8, n_sym=65536, lo=1000, hi=64536, n=64800):
    """Per channel, the codewords (index within the channel) that lie
    wholly within symbols [lo, hi) of one polarization (4 bits/symbol,
    mode-major), with that polarization."""
    out = []
    for c in range(n_cw):
        s0, s1 = c * n // 4, (c + 1) * n // 4 - 1
        if s0 // n_sym == s1 // n_sym and s0 % n_sym >= lo and s1 % n_sym < hi:
            out.append((c, s0 // n_sym))
    return out


def run_coded_path_d(dev, res, n_train=12000, n_channels=11, seed=7):
    """Path D: the coded WDM link. Encoded DVB-S2 R4/5 codewords on the
    north-star Tx and channel, path C's receiver, taps trained on the
    rolled front end, then coherent_coded_serve at its default FEC config
    (K1, K11)."""
    from unittest import mock

    from opticommpy_torch.comm import fec, fec_qc
    from opticommpy_torch.comm.fec import encode_ldpc, standard_ldpc
    from opticommpy_torch.comm.modulation import gray_mapping, modulate_gray, norm_const
    from opticommpy_torch.dsp import MIMOEqualizerConfig, edc, mimo_adapt_equalizer_batch
    from opticommpy_torch.kernels import bps, ldpc, qc, qc_mega
    from opticommpy_torch.models import manakov_ssf
    from opticommpy_torch.models.tx import WDMTxConfig, wdm_tx_build, wdm_tx_draw
    from opticommpy_torch.ops import fir_filter, pnorm
    from opticommpy_torch.pipelines import CoherentDSPConfig, coherent_coded_serve

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_sym, n_cw = 65536, 8 * n_channels
    _, edges = standard_ldpc("DVBS2", 64800, "4/5")
    info = torch.randint(0, 2, (51840, n_cw), generator=gen, device=dev, dtype=torch.int32)
    cw = encode_ldpc(info, edges=edges)  # (64800, 88) int8 on the card
    tail = torch.randint(0, 2, (n_channels, 8 * n_sym - 8 * 64800), generator=gen, device=dev,
                         dtype=torch.int8)
    streams = torch.cat([cw.T.reshape(n_channels, 8 * 64800), tail], dim=1)
    es = float(np.sqrt(np.mean(np.abs(gray_mapping(16, "qam")) ** 2)))
    syms = (modulate_gray(streams.reshape(-1), 16, "qam") / es).to(torch.complex64)
    syms = syms.reshape(n_channels, 2, n_sym)  # mode-major: pol 0's symbols first
    cfg_tx = WDMTxConfig(M=16, Rs=32e9, SpS=16, nBits=4 * n_sym, nChannels=n_channels,
                         nPolModes=2, nFilterTaps=1024, pulseRollOff=0.01,
                         powerPerChannel=(-2.0,), wdmGridSpacing=37.5e9,
                         laserLinewidth=100e3)
    _, pn = wdm_tx_draw(gen, cfg_tx)
    sig_tx, symb_tx, _ = wdm_tx_build(syms, pn, cfg_tx)
    sig_ch = manakov_ssf(sig_tx, res["cfg_ch"], gen)
    x_b, _, ref_b, _, pulse2, edc_cfg = serve_inputs(
        dict(sig_ch=sig_ch, gen=gen, symb_tx=symb_tx), n_channels)
    # roll each serving input so that the served stream starts at the first
    # Tx symbol (the SSFM is circular); the front end and the training
    # reference follow the rolled input
    ref_tx = torch.stack([pnorm(symb_tx[:, :, k]) for k in range(n_channels)])
    xs, fronts, scales, delays = [], [], [], []
    for k in range(n_channels):
        d = [_sync_delay(ref_b[k, :, p], ref_tx[k, :, p]) for p in range(2)]
        _check(d[0] == d[1], f"path D ch {k}: the polarizations' delays differ: {d}")
        x = torch.roll(x_b[k], -2 * d[0], dims=0)
        pre = edc(fir_filter(pulse2, x), edc_cfg)
        s = torch.sqrt(torch.mean((pre * pre.conj()).real))
        xs.append(x)
        fronts.append(pre / s)
        scales.append(s)
        delays.append(d[0])
    del x_b, ref_b
    x_b, front_b, scale_b = torch.stack(xs), torch.stack(fronts), torch.stack(scales)
    del xs, fronts
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"path D: Tx + channel + receive {setup_s:.2f} s; symbol delays {delays}")

    eq_cfg = MIMOEqualizerConfig(nTaps=15, SpS=2, mu=(5e-3, 2e-3), alg=("da-rde", "dd-lms"),
                                 L=(n_train, n_sym - n_train), M=16, numIter=2,
                                 backend="pallas")
    _reset_counts()
    (y_eq, H_b, _), train_s = _wall(lambda: mimo_adapt_equalizer_batch(
        front_b, eq_cfg, symb_ref=ref_tx, return_results=True))
    train_counts = _counts()
    _check(train_counts == _expect(mimo_eq_batch=3), f"path D training: {train_counts}")
    # noise variance over the training span; the phase-blind da-rde output
    # carries the lasers' phase, so each 64-symbol block is first turned by
    # its own least-squares phase against the reference
    yt, rt = y_eq[:, :n_train], ref_tx[:, :n_train]
    raw_var = float(torch.mean(torch.abs(yt - rt) ** 2))
    nb = n_train // 64
    yb = yt[:, :nb * 64].reshape(n_channels, nb, 64, 2)
    rb = rt[:, :nb * 64].reshape(n_channels, nb, 64, 2)
    ph = torch.angle(torch.sum(yb * rb.conj(), dim=2, keepdim=True))
    noise_var = float(torch.mean(torch.abs(yb * torch.exp(-1j * ph) - rb) ** 2))
    print(f"path D training: launches {train_counts}, {train_s:.3f} s; noise_var {noise_var:.5f} "
          f"(mean |y - ref|^2 over the training span after a per-64-symbol phase; without "
          f"it {raw_var:.4f})")

    cfg = CoherentDSPConfig(SpS_in=16, L=250, nTrain=n_train, mu=(5e-3, 2e-3))
    fec_cfg = None  # coherent_coded_serve's default: NMSA-20, bf16, early exit (K11)
    pilots = ref_tx[:, :512]
    captured = {}
    real_decode = fec.decode_ldpc

    def decode_spy(llrs, **kw):
        captured["llrs"] = llrs
        return real_decode(llrs, **kw)

    plain = [mock.patch.object(qc, "check_column_plain", wraps=qc.check_column_plain),
             mock.patch.object(qc, "var_totals_plain", wraps=qc.var_totals_plain),
             mock.patch.object(qc_mega, "mega_decode_plain", wraps=qc_mega.mega_decode_plain),
             mock.patch.object(ldpc, "check_update_msa_plain",
                               wraps=ldpc.check_update_msa_plain),
             mock.patch.object(fec_qc, "_check_msa_slots", wraps=fec_qc._check_msa_slots),
             mock.patch.object(bps, "bps_indices_plain", wraps=bps.bps_indices_plain),
             mock.patch.object(fec, "decode_ldpc", decode_spy)]
    spies = [p.start() for p in plain]
    try:
        _reset_counts()
        (bits, fail, out), serve_s = _wall(lambda: coherent_coded_serve(
            x_b, H_b, cfg, noise_var, fec_config=fec_cfg, pilot_grid=pilots, scale=scale_b))
        counts = _counts()
        plain_calls = [s.call_count for s in spies[:-1]]
    finally:
        for p in plain:
            p.stop()
    _, n_iters, _ = fec_qc.make_qc_decoder(64800, "4/5", 20, "NMSA", "bf16", True)(
        torch.clamp(captured["llrs"], -200.0, 200.0))
    print(f"path D serve + decode launches: {counts} (iterations mean "
          f"{float(n_iters.float().mean()):.2f} max {int(n_iters.max())}); plain-version "
          f"calls {plain_calls}; {serve_s:.3f} s for {n_cw} codewords")
    _check(counts == _expect(bps=1, unwrap=1, qc_mega=1),
           f"path D: launches {counts}, expected K1 1, K15 1, K11 1 and no K9/K10")
    _check(not any(plain_calls), f"path D reached a plain version: {plain_calls}")
    _check(tuple(bits.shape) == (64800, n_cw) and tuple(fail.shape) == (n_cw,)
           and tuple(out.shape) == (n_channels, n_sym, 2) and bool(torch.isfinite(out).all()),
           f"path D: outputs {tuple(bits.shape)} {tuple(fail.shape)} {tuple(out.shape)}")

    # served symbols against the Tx: symbol errors per 1024-symbol block;
    # a quarter-turn BPS slip turns every later symbol of its polarization
    const = torch.as_tensor(norm_const(16, "qam"), device=dev)

    def nearest(z):
        return torch.argmin(torch.abs(z[..., None] - const), dim=-1)

    wrong = (nearest(out) != nearest(ref_tx)).float()[:, 1000:64536]  # (ch, sym, pol)
    n_blk = wrong.shape[1] // 1024
    blocks = wrong[:, :n_blk * 1024].reshape(n_channels, n_blk, 1024, 2).mean(dim=2)
    bad = (blocks > 0.5).cpu().numpy()  # (ch, block, pol)
    slipped = bad.any(axis=1)  # (ch, pol)
    # first symbol of the first block past a slip, per (channel, pol)
    slip_at = [[1000 + 1024 * int(np.argmax(bad[k, :, p])) if slipped[k, p] else None
                for p in range(2)] for k in range(n_channels)]
    ser = wrong.mean(dim=1).cpu().numpy()
    info_err = (bits[:51840].to(torch.int32) != info).sum(dim=0).cpu().numpy()
    fail_np = fail.cpu().numpy()
    clean = _clean_codewords()
    failures = []
    for k in range(n_channels):
        cols = slice(8 * k, 8 * k + 8)
        print(f"  D ch {k:2d}: SER {ser[k, 0]:.2e} {ser[k, 1]:.2e}, slip at {slip_at[k]}; "
              f"frames failed {int(fail_np[cols].sum())} of 8 {fail_np[cols].tolist()}, "
              f"post-FEC info bit errors {int(info_err[cols].sum())} "
              f"{info_err[cols].tolist()}")
        if not slipped[k].any():
            for c, _ in clean:
                if info_err[8 * k + c] or fail_np[8 * k + c]:
                    failures.append(f"ch {k} codeword {c}: {int(info_err[8 * k + c])} errors, "
                                    f"fail {int(fail_np[8 * k + c])}")
    n_clean = sum(1 for k in range(n_channels) if not slipped[k].any()) * len(clean)
    print(f"path D: frames failed {int(fail_np.sum())} of {n_cw}, post-FEC info bit errors "
          f"{int(info_err.sum())}; slipped (channel, pol): "
          f"{[(k, p) for k in range(n_channels) for p in range(2) if slipped[k, p]]}; "
          f"clean codewords {clean} per channel, {n_clean} checked")
    _check(not failures, "path D: clean codewords with errors:\n  " + "\n  ".join(failures))

    # the same receiver on the CPU (the kernels' plain versions): channels 0,
    # 5 and 10
    sel = [k for k in (0, n_channels // 2, n_channels - 1)]
    (bits_c, fail_c, _), cpu_s = _wall(lambda: coherent_coded_serve(
        x_b[sel].cpu(), H_b[sel].cpu(), cfg, noise_var, fec_config=fec_cfg,
        pilot_grid=pilots[sel].cpu(), scale=scale_b[sel].cpu()))
    cols = [8 * k + c for k in sel for c in range(8)]
    bits_g, fail_g = bits[:, cols].cpu(), fail[cols].cpu()
    both = (fail_g == 0) & (fail_c == 0)
    diff_failed = int((bits_g[:, ~both] != bits_c[:, ~both]).sum())
    same_bits = bool(torch.equal(bits_g[:, both], bits_c[:, both]))
    print(f"path D on the CPU (plain versions), channels {sel}: {cpu_s:.1f} s; fail flags equal "
          f"{bool(torch.equal(fail_g, fail_c))} ({fail_c.tolist()}); decided bits equal on the "
          f"{int(both.sum())} decoded frames {same_bits}; differing bits on the others "
          f"{diff_failed}")
    _check(bool(torch.equal(fail_g, fail_c)) and same_bits,
           "path D: the CPU receiver decides otherwise")
    _check(not fail_np.any() and not info_err.any(),
           f"path D: {int(fail_np.sum())} of {n_cw} frames failed, {int(info_err.sum())} "
           "post-FEC errors")
    return dict(train_counts=train_counts, counts=counts, serve_s=serve_s,
                noise_var=noise_var, frames_failed=int(fail_np.sum()),
                bit_errors=int(info_err.sum()))



# -- IM-DD: K13 (DFE / FFE) and K14 (Volterra), path H -----------------------

IMDD_Y_ATOL = 1e-4  # path H, CUDA chain vs CPU chain: max |y| difference (decisions equal)
VOL_PREFIX_ATOL = 1e-5  # path H Volterra, CUDA kernel vs CPU plain version, 4,096 symbols


def _dfe_cost(n_b, n_sym, n_ff, n_fb, sps, cplx):
    """(bytes, flops) of one DFE/FFE pass: the padded signal, the references,
    the taps in and out, y and the error power; per symbol and tap a
    product, a tree add and the update's three operations (x4 complex),
    and ~10 for the slicer and the error."""
    w = 8 if cplx else 4
    nbytes = n_b * (w * ((n_sym - 1) * sps + n_ff) + w * n_sym + 2 * w * (n_ff + n_fb)
                    + (w + 4) * n_sym)
    return nbytes, n_b * n_sym * ((20 if cplx else 5) * (n_ff + n_fb) + 10)


def _volterra_cost(n_b, n_sym, n_adapt, n1, n2, n3, order, sps):
    """(bytes, flops) of one Volterra pass: the padded signal, the
    references, the flat taps in and out, y and the error power. Per
    symbol: each distinct feature product once (x[a] x[b] equals x[b] x[a],
    so one pair product serves both orders of the pair and every order-3
    feature built on it), the Q products with the taps and their Q - 1
    adds, and ~10 for the slicer and the error. Per adapting symbol (n_adapt
    of a signal's: n_train, or every symbol with fulltime): the update's
    product and add per tap and three for the gains. The symbols after
    training keep their taps, so they pay no update."""
    from opticommpy_torch.kernels import volterra

    idx, kind = volterra.feature_table(n1, n2, n3, order)
    n_q = idx.shape[1]
    pairs = {frozenset((a, b)) for a, b, _, k in zip(*idx.tolist(), kind.tolist()) if k >= 2}
    triples = {(frozenset((a, b)), c) for a, b, c, k in zip(*idx.tolist(), kind.tolist())
               if k == 3}
    nbytes = n_b * (4 * ((n_sym - 1) * sps + n1) + 4 * n_sym + 8 * n_q + 8 * n_sym)
    per_sym = len(pairs) + len(triples) + 2 * n_q - 1 + 10
    return nbytes, n_b * (n_sym * per_sym + n_adapt * (2 * n_q + 3))


def _pam_isi(n_b, n_sym, seed, h=(0.1, 0.25, 1.0, 0.3, -0.1), noise=0.03):
    """(x (n_b, n_sym), symbols (n_b, n_sym)) float32: normalized PAM4
    through an ISI channel with noise, one seed per row."""
    out_x, out_s = [], []
    const = np.array([-3.0, -1.0, 1.0, 3.0]) / np.sqrt(5)
    for b in range(n_b):
        r = np.random.default_rng(seed + b)
        sym = const[r.integers(0, 4, size=n_sym)]
        out_x.append(np.convolve(sym, h, "same") + noise * r.normal(size=n_sym))
        out_s.append(sym)
    return np.stack(out_x).astype(np.float32), np.stack(out_s).astype(np.float32)


def _cplx_isi(n_b, n_sym, const, seed):
    out_x, out_s = [], []
    h = np.array([0.1 + 0.05j, 1.0, 0.2 - 0.1j])
    for b in range(n_b):
        r = np.random.default_rng(seed + b)
        sym = const[r.integers(0, len(const), size=n_sym)]
        out_x.append(np.convolve(sym, h, "same")
                     + 0.02 * (r.normal(size=n_sym) + 1j * r.normal(size=n_sym)))
        out_s.append(sym)
    return np.stack(out_x).astype(np.complex64), np.stack(out_s).astype(np.complex64)


def _nl_pam(n_b, n_sym, sps=2, seed=4):
    """bench_dsp.py:355-358's Volterra signal, one noise draw per row."""
    out_x, out_s = [], []
    for b in range(n_b):
        r = np.random.default_rng(seed + b)
        sym = (2 * r.integers(0, 4, size=n_sym) - 3).astype(np.float32)
        sig = np.repeat(sym, sps) + 0.1 * r.normal(size=n_sym * sps)
        out_x.append(sig + 0.05 * sig**2)
        out_s.append(sym)
    return np.stack(out_x).astype(np.float32), np.stack(out_s).astype(np.float32)


def phase_imdd_kernels(dev, n_pam=16384, n_cplx=4096, n_vol=16384):
    """K13 and K14 against their plain versions on the card, and their
    times. Every comparison is exact."""
    from opticommpy_torch.comm.metrics import fast_ber_calc
    from opticommpy_torch.dsp.equalization import VolterraConfig
    from opticommpy_torch.kernels import dfe, volterra
    from opticommpy_torch.ops.signal import pnorm

    report = {}
    ms_clock = {}  # SM clock after each timed window

    def prepared(x, s, n_ff, const):
        sig_pad, ref, n_out, _ = dfe.prepare(torch.as_tensor(x, device=dev),
                                              torch.as_tensor(s, device=dev), n_ff, 1, const)
        return sig_pad, ref, n_out

    def compare(name, sig_pad, ref, const, n_ff, n_fb, use_fb, n_train, fulltime, timed=False):
        dt = sig_pad.dtype
        f0 = torch.zeros((sig_pad.shape[0], n_ff), dtype=dt, device=dev)
        f0[:, n_ff // 2] = 1.0
        b0 = torch.zeros((sig_pad.shape[0], n_fb), dtype=dt, device=dev)
        args = (const, f0, b0, ref.shape[1], 1, 2e-3, n_train, fulltime, use_fb)
        out_k = dfe.dfe_run(sig_pad, ref, *args)
        out_p, plain_s = _wall(lambda: dfe.dfe_pass_plain(sig_pad, ref, *args))
        same = all(bool(torch.equal(a, b)) for a, b in zip(out_k, out_p))
        err = max(float((a - b).abs().max()) for a, b in zip(out_k, out_p))
        ms = _cuda_ms(lambda: dfe.dfe_run(sig_pad, ref, *args), 5) if timed else None
        if timed:
            ms_clock[name] = _sm_clock_mhz()
        print(f"K13 {name} ({sig_pad.shape[0]} x {ref.shape[1]} symbols, {n_ff}/"
              f"{n_fb if use_fb else 0} taps): equal to plain {same} (max |diff| {err:.3e}), "
              f"plain {plain_s * 1e3:.1f} ms" + (f", kernel {ms:.3f} ms" if timed else ""))
        _check(same, f"K13 {name}: kernel disagrees with its plain version")
        return out_k, ms, plain_s, err

    # K13 at the serving shape: PAM4, 8 x 16,384 symbols, IMDDConfig's taps
    pam = dfe.norm_const(4, "pam")
    x, s = _pam_isi(8, n_pam, 70)
    sig_pad, ref, _ = prepared(x, s, 15, pam)
    out, ms, plain_s, err = compare("DFE PAM4 real", sig_pad, ref, pam, 15, 5, True, 8000, True,
                                    timed=True)
    dfe_entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_s * 1e3)
    dfe_cost = _dfe_cost(8, n_pam, 15, 5, 1, False)
    compare("FFE PAM4 real", sig_pad, ref, pam, 15, 1, False, 8000, True, timed=True)
    # batch against single, per signal
    one = dfe.dfe_run(sig_pad[5:6].contiguous(), ref[5:6].contiguous(), pam,
                      torch.tensor([[0.0] * 7 + [1.0] + [0.0] * 7], device=dev),
                      torch.zeros((1, 5), device=dev), n_pam, 1, 2e-3, 8000, True, True)
    same_b = all(bool(torch.equal(a[5:6], b)) for a, b in zip(out, one))
    print(f"K13 batch of 8 against signal 5 alone: equal {same_b}")
    _check(same_b, "K13: a signal's result depends on its batch")
    # square 16-QAM (per-axis quantizer) and 8-PSK (argmin), complex instance
    qam = dfe.norm_const(16, "qam")
    xq, sq = _cplx_isi(8, n_cplx, qam, 80)
    sp_q, ref_q, _ = prepared(xq, sq, 7, qam)
    compare("DFE 16-QAM fulltime", sp_q, ref_q, qam, 7, 3, True, 1500, True)
    psk = np.exp(2j * np.pi * np.arange(8) / 8).astype(np.complex64)
    xp, spk = _cplx_isi(8, n_cplx, psk, 90)
    sp_p, ref_p, _ = prepared(xp, spk, 7, psk)
    compare("DFE 8-PSK argmin", sp_p, ref_p, psk, 7, 3, True, 1500, False)
    # the PAM4 signal on the complex instance: its real parts exactly
    out_c = dfe.dfe_run(sig_pad.to(torch.complex64), ref.to(torch.complex64), pam,
                        torch.tensor([[0.0] * 7 + [1.0] + [0.0] * 7] * 8, device=dev,
                                     dtype=torch.complex64),
                        torch.zeros((8, 5), device=dev, dtype=torch.complex64), n_pam, 1, 2e-3,
                        8000, True, True)
    same_c = all(bool(torch.equal(a, b.real if b.is_complex() else b))
                 for a, b in zip(out, out_c))
    print(f"K13 PAM4 on the complex instance: real parts equal to the real instance {same_c}")
    _check(same_c, "K13: the complex instance disagrees with the real one at PAM")
    report["dfe"] = _with_cycles(_with_bound(dfe_entry, *dfe_cost), n_pam,
                                 ms_clock["DFE PAM4 real"])

    # K14 at bench_dsp.py:350-367's shape: B = 8 x 16,384 symbols, SpS 2,
    # 13 / 7 / 5 taps, mu 1e-3, nTrain 4000
    xv, sv = _nl_pam(8, n_vol)
    ref_n = torch.stack([pnorm(r) for r in torch.as_tensor(sv, device=dev)])
    for order in (2, 3):
        cfg = VolterraConfig(n1Taps=13, n2Taps=7, n3Taps=5, SpS=2, mu=1e-3, nTrain=4000,
                             order=order, M=4, constType="pam")
        sig_pad_v, ref_v, h0, n_out, _ = volterra.prepare(torch.as_tensor(xv, device=dev),
                                                          torch.as_tensor(sv, device=dev), cfg)
        args = (h0, n_out, 2, 13, 7, 5, order, volterra._levels(4, "pam"), 1e-3, 4000, False)
        out_k = volterra.volterra_run(sig_pad_v, ref_v, *args)
        out_p, plain_s = _wall(lambda: volterra.volterra_pass_plain(sig_pad_v, ref_v, *args))
        same = all(bool(torch.equal(a, b)) for a, b in zip(out_k, out_p))
        err = max(float((a - b).abs().max()) for a, b in zip(out_k, out_p))
        ms = _cuda_ms(lambda: volterra.volterra_run(sig_pad_v, ref_v, *args), 5)
        y_n = torch.stack([pnorm(r) for r in out_k[0]])
        bers = [float(fast_ber_calc(y_n[b, 4000:], ref_n[b, 4000:], 4, "pam")[0][0])
                for b in range(8)]
        print(f"K14 volterra order {order} (8 x {n_out} symbols, {h0.shape[1]} taps): equal to "
              f"plain {same} (max |diff| {err:.3e}), kernel {ms:.3f} ms, plain "
              f"{plain_s * 1e3:.1f} ms; BER after nTrain {bers}")
        _check(same, f"K14 order {order}: kernel disagrees with its plain version")
        _check(max(bers) == 0.0, f"K14 order {order}: BER after nTrain {bers}, expected 0")
        if order == 3:
            report["volterra"] = _with_cycles(_with_bound(
                dict(max_abs_err=err, ms=ms, plain_ms=plain_s * 1e3),
                *_volterra_cost(8, n_out, 4000, 13, 7, 5, 3, 2)), n_out, _sm_clock_mhz())
            print(f"K14 order 3: {report['volterra']['cycles_per_symbol']:.1f} cycles per symbol "
                  f"at {report['volterra']['sm_clock_mhz']:.0f} MHz; bound "
                  f"{report['volterra']['bound_ms']:.6f} ms ({report['volterra']['bound_by']}, "
                  f"the update counted on the 4000 training symbols only)")
    _volterra_exact_check(dev)
    return report


def _volterra_exact_check(dev):
    """K14's exact replacements of a division, on every float32 input: its
    quotient by 7 against __fdiv_rn(x, 7) and its threshold slicer against
    the dividing slicer, at PAM4 and PAM8 levels. No input may differ."""
    from opticommpy_torch.kernels import _build, volterra

    lib = _build.load_library()
    for m in (4, 8):
        levels = volterra._levels(m, "pam")
        n, thr = volterra.slicer_thresholds(levels)
        thr_t = torch.as_tensor(thr.copy(), device=dev)
        bad = torch.zeros(12, dtype=torch.int64, device=dev)
        t0 = time.perf_counter()
        _build.check(lib.volterra_exact_check(0, 1 << 32, _build.ptr(thr_t), n,
                                              float(levels[0]), float(levels[1] - levels[0]),
                                              float(n - 1), _build.ptr(bad),
                                              _build.stream_ptr(dev)), "volterra_exact_check")
        torch.cuda.synchronize()
        counts = bad.tolist()
        print(f"K14 exact check over all 2^32 float32 inputs (PAM{m} levels, "
              f"{time.perf_counter() - t0:.3f} s): quotient by 7 differs on {counts[0]}, "
              f"threshold slicer on {counts[1]} (first inputs {counts[2:10]})")
        _check(counts[:2] == [0, 0], f"K14: an exact replacement of a division differs "
               f"(PAM{m}): {counts}")


def imdd_links(dev, n_links=8, n_bits=2**17, seed=5):
    """Path H's links built on the card by the port: pam_transmitter's draw
    and build (links as columns) -> linear_fiber_channel -> photodiode per
    link. Returns (currents (B, N) float32, symbols (B, nSym) float32)."""
    from opticommpy_torch.models import LinearFiberConfig, PhotodiodeConfig
    from opticommpy_torch.models.channels import linear_fiber_channel
    from opticommpy_torch.models.devices import photodiode
    from opticommpy_torch.models.tx import PAMTxConfig, pam_tx_build, pam_tx_draw

    # one column per link: pam_tx_build gives each column its own peak and power
    cfg_tx = PAMTxConfig(M=4, Rs=25e9, SpS=8, nBits=n_bits, pulseType="nrz", power=3.0,
                         nPolModes=n_links)
    fs = cfg_tx.Fs
    gen = torch.Generator(device=dev).manual_seed(seed)
    symb = pam_tx_draw(gen, cfg_tx)  # (nSym, B)
    rx = linear_fiber_channel(pam_tx_build(symb, cfg_tx),
                              LinearFiberConfig(L=10, alpha=0.2, D=17, Fs=fs))
    pd = PhotodiodeConfig(Fs=fs, B=20e9)
    i_b = torch.stack([photodiode(rx[:, b], pd, gen) for b in range(n_links)])
    return i_b.to(torch.float32).contiguous(), symb.T.contiguous()


def _imdd_scores(y, mse, ref, n_train):
    """Per link (BER after 2 n_train, MSE of the last 4,000 symbols)."""
    from opticommpy_torch.comm.metrics import fast_ber_calc
    from opticommpy_torch.ops.signal import pnorm

    post = 2 * n_train
    rows = []
    for b in range(y.shape[0]):
        ber = fast_ber_calc(y[b, post:].real, pnorm(ref[b])[post:], 4, "pam")[0]
        rows.append((float(ber[0]), float(mse[b, -4000:].mean())))
    return rows


def _pam_decisions(y):
    """Nearest normalized PAM4 level of each real symbol."""
    lev = torch.tensor([-3.0, -1.0, 1.0, 3.0], device=y.device) / np.sqrt(5.0)
    return torch.argmin((y.real[..., None] - lev).abs(), dim=-1)


def run_imdd_path_h(dev, n_links=8, n_bits=2**17, n_cmp=16384, n_wide=132):
    """Path H: IM-DD serving at the JAX package's bench size
    (bench.run_imdd_chain): 8 links through imdd_dsp_chain_batch with the
    DFE (K13 1 launch) and the FFE (K13 1 launch), then the same links'
    SpS-2 samples through volterra_kernel (K14 1 launch)."""
    from unittest import mock

    from opticommpy_torch.dsp.equalization import VolterraConfig
    from opticommpy_torch.kernels import dfe, volterra
    from opticommpy_torch.ops.signal import row_mean
    from opticommpy_torch.pipelines import IMDDConfig, imdd_dsp_chain_batch

    (i_b, ref_b), build_s = _wall(lambda: imdd_links(dev, n_links, n_bits))
    n_sym = ref_b.shape[1]
    print(f"path H: {n_links} links x {i_b.shape[1]} samples ({n_sym} PAM4 symbols) built on "
          f"the card in {build_s:.3f} s")
    out = {}
    failures = []
    for eq in ("dfe", "ffe"):
        cfg = IMDDConfig(SpS_in=8, nTapsFF=15, nTapsFB=5, mu=2e-3, nTrain=8000, eq=eq)
        _reset_counts()
        (y, mse), first_s = _wall(lambda: imdd_dsp_chain_batch(i_b, ref_b, cfg))
        counts = _counts()
        _check(counts == _expect(dfe=1), f"path H {eq}: launches {counts}, expected K13 1")
        _check(tuple(y.shape) == (n_links, n_sym) and y.is_cuda
               and bool(torch.isfinite(y).all()) and bool(torch.isfinite(mse).all()),
               f"path H {eq}: output {tuple(y.shape)} not finite or misplaced")
        rows = _imdd_scores(y, mse, ref_b, cfg.nTrain)
        ms = _cuda_ms(lambda: imdd_dsp_chain_batch(i_b, ref_b, cfg), 3)
        # K13 alone on the arguments the chain gives it (the shape the path
        # launches); these launches are not the path's
        with mock.patch.object(dfe, "dfe_run", wraps=dfe.dfe_run) as k13:
            imdd_dsp_chain_batch(i_b, ref_b, cfg)
        k_args = k13.call_args.args
        k_ms = _cuda_ms(lambda: dfe.dfe_run(*k_args), 3)
        k_mhz = _sm_clock_mhz()
        k_cost = _dfe_cost(n_links, k_args[5], cfg.nTapsFF, cfg.nTapsFB if eq == "dfe" else 0,
                           1, False)
        k13_alone = _with_cycles(dict(ms=k_ms, n_batch=n_links, n_sym=k_args[5]), k_args[5],
                                 k_mhz)
        k13_alone["bound_ms"], k13_alone["bound_by"] = _bound(*k_cost)
        # and against its plain version on the card on the same arguments,
        # every output bit for bit
        out_k = dfe.dfe_run(*k_args)
        out_p, k_plain_s = _wall(lambda: dfe.dfe_pass_plain(*k_args))
        k_same = all(bool(torch.equal(a, b)) for a, b in zip(out_k, out_p))
        k13_alone["max_abs_err"] = max(float((a - b).abs().max()) for a, b in zip(out_k, out_p))
        k13_alone["plain_ms"] = k_plain_s * 1e3
        print(f"path H {eq}: K13 alone on the chain's {n_links} x {k_args[5]} symbols "
              f"{k_ms:.3f} ms ({k13_alone['cycles_per_symbol']:.1f} cycles per symbol at "
              f"{k_mhz:.0f} MHz; bound {k13_alone['bound_ms']:.6f} ms); equal to plain "
              f"{k_same} (max |diff| {k13_alone['max_abs_err']:.3e}, plain {k_plain_s:.1f} s)")
        _check(k_same, f"path H {eq}: K13 disagrees with its plain version at the path's shape")
        print(f"path H {eq}: launches K13 {counts['dfe']}; first call {first_s * 1e3:.1f} ms, "
              f"warm {ms:.3f} ms = {n_links * n_sym / ms / 1e3:.4f} Msym/s aggregate "
              f"(B = {n_links})")
        print(f"path H {eq} per link (BER after 2 nTrain, tail MSE): {rows}")
        for b, (ber, tail) in enumerate(rows):
            if not (ber < 1e-3 and tail < 0.05):
                failures.append(f"path H {eq} link {b}: BER {ber}, tail MSE {tail}")
        med = float(np.median([r[0] for r in rows]))
        med_jax = float(np.median([r[0] for r in JAX_IMDD[eq]]))
        print(f"path H {eq}: median BER {med:.3e}, JAX {med_jax:.3e}")
        if med > 2 * med_jax + 1e-4:
            failures.append(f"path H {eq}: median BER {med} above 2 x JAX {med_jax} + 1e-4")
        # the chain on CPU tensors (the plain version) on every link's first
        # n_cmp symbols, against the same chain on the card
        i_c, r_c = i_b[:, :8 * n_cmp], ref_b[:, :n_cmp]
        y_g, _ = imdd_dsp_chain_batch(i_c, r_c, cfg)
        y_c, cpu_s = _wall(lambda: imdd_dsp_chain_batch(i_c.cpu(), r_c.cpu(), cfg)[0])
        flips = int((_pam_decisions(y_g.cpu()) != _pam_decisions(y_c)).sum())
        d = float((y_g.cpu() - y_c).abs().max())
        print(f"path H {eq} on {n_links} x {n_cmp} symbols, CUDA against the CPU plain chain "
              f"({cpu_s:.1f} s): differing decisions {flips}, max |y diff| {d:.3e}, "
              f"bit for bit {bool(torch.equal(y_g.cpu(), y_c))}")
        _check(flips == 0 and d < IMDD_Y_ATOL,
               f"path H {eq}: the CPU chain decides otherwise ({flips}, {d})")
        out[eq] = dict(counts=counts, ms=ms, rows=rows, k13=k13_alone)
    # the serving batch at one link per SM: time only
    wide = i_b.repeat(-(-n_wide // n_links), 1)[:n_wide].contiguous()
    wide_ref = ref_b.repeat(-(-n_wide // n_links), 1)[:n_wide].contiguous()
    cfg = IMDDConfig(SpS_in=8, nTapsFF=15, nTapsFB=5, mu=2e-3, nTrain=8000)
    ms_w = _cuda_ms(lambda: imdd_dsp_chain_batch(wide, wide_ref, cfg), 2)
    print(f"path H dfe at B = {n_wide} (links repeated; time only): warm {ms_w:.3f} ms = "
          f"{n_wide * n_sym / ms_w / 1e3:.4f} Msym/s aggregate")
    out["wide_ms"] = ms_w
    del wide, wide_ref

    # Volterra on the same links at SpS 2 (K14)
    x2 = (i_b - row_mean(i_b)[:, None])[:, ::4].contiguous()
    vcfg = VolterraConfig(n1Taps=13, n2Taps=7, n3Taps=5, SpS=2, mu=1e-3, nTrain=4000, order=3,
                          M=4, constType="pam")
    _reset_counts()
    (yv, _, msev), vol_s = _wall(lambda: volterra.volterra_kernel(x2, ref_b, vcfg))
    vol_counts = _counts()
    _check(vol_counts == _expect(volterra=1),
           f"path H volterra: launches {vol_counts}, expected K14 1")
    _check(bool(torch.isfinite(yv).all()), "path H volterra: non-finite output")
    vrows = _imdd_scores(yv, msev, ref_b, vcfg.nTrain)
    print(f"path H volterra (order 3, 13/7/5, SpS 2): launches K14 {vol_counts['volterra']}, "
          f"{vol_s * 1e3:.1f} ms; per link (BER after 2 nTrain, tail MSE): {vrows}")
    sig_pad, ref_v, h0, _, _ = volterra.prepare(x2, ref_b, vcfg)
    args = (2, 13, 7, 5, 3, volterra._levels(4, "pam"), 1e-3, 4000, False)
    n_pre = 4096
    pre_k = volterra.volterra_run(sig_pad, ref_v[:, :n_pre].contiguous(), h0, n_pre, *args)
    pre_c = volterra.volterra_pass_plain(sig_pad.cpu(), ref_v[:, :n_pre].cpu(), h0.cpu(), n_pre,
                                         *args)
    verr = max(float((a.cpu() - b).abs().max()) for a, b in zip(pre_k, pre_c))
    vsame = all(bool(torch.equal(a.cpu(), b)) for a, b in zip(pre_k, pre_c))
    print(f"path H volterra on {n_links} x {n_pre} symbols, kernel against the CPU plain "
          f"version: equal {vsame}, max |diff| {verr:.3e}")
    _check(verr < VOL_PREFIX_ATOL, f"path H volterra: CPU plain version differs by {verr}")
    # K14 alone on the arguments the path gives it (these launches are not
    # the path's)
    with mock.patch.object(volterra, "volterra_run", wraps=volterra.volterra_run) as k14:
        volterra.volterra_kernel(x2, ref_b, vcfg)
    v_args = k14.call_args.args
    v_ms = _cuda_ms(lambda: volterra.volterra_run(*v_args), 3)
    k14_alone = _with_cycles(dict(ms=v_ms, n_batch=n_links, n_sym=v_args[3]), v_args[3],
                             _sm_clock_mhz())
    n_adapt = v_args[3] if v_args[12] else min(v_args[11], v_args[3])
    k14_alone["bound_ms"], k14_alone["bound_by"] = _bound(*_volterra_cost(
        n_links, v_args[3], n_adapt, 13, 7, 5, 3, 2))
    print(f"path H volterra: K14 alone on the path's {n_links} x {v_args[3]} symbols "
          f"{v_ms:.3f} ms ({k14_alone['cycles_per_symbol']:.1f} cycles per symbol at "
          f"{k14_alone['sm_clock_mhz']:.0f} MHz; bound {k14_alone['bound_ms']:.6f} ms)")
    out.update(vol_counts=vol_counts, vol_rows=vrows, failures=failures, k14=k14_alone)
    return out


DBP_POWERS = (-2.0, 0.0, 2.0, 4.0, 6.0)
SPAN_REL = 1e-4  # path I and phase J: an SSFM / DBP span on CUDA vs CPU, relative
STAT_REL = 0.02  # phase J, a drawn noise variance against its model
# path I on the JAX package's seed-7 symbols: |port - JAX| mean SNR per power and
# arm [dB]. Both receivers then see one transmitter; the packages met within
# 0.0022 dB there on an H100, while other transmitters move the DBP arm's mean
# SNR by up to 1.8 dB at 4 dBm (tools/torch_dbp_witness.py; PERF.md)
SAME_SYMB_SNR_DB = 0.05
DBP_JAX_SYMBOLS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                               "dbp_jax_seed7_symbols.npz")


def _rel(a, b):
    """||a - b|| / ||b|| over all elements (float64, on the host)."""
    a = a.detach().cpu().to(torch.complex128)
    b = b.detach().cpu().to(torch.complex128)
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _dbp_arm(sig_cd, symb_ref, n_train=4000, disc=5000):
    """One arm of path I: symbol_sync, the MIMO equalizer on K2 (nlms twice,
    then dd-lms), BPS on K1; (y, d) after the discarded symbols."""
    from opticommpy_torch.dsp import CPRConfig, MIMOEqualizerConfig, cpr, mimo_adapt_equalizer
    from opticommpy_torch.ops import pnorm, symbol_sync

    d_ref = pnorm(symbol_sync(sig_cd, symb_ref, 2))
    n_sym = d_ref.shape[0]
    y = mimo_adapt_equalizer(
        pnorm(sig_cd),
        MIMOEqualizerConfig(nTaps=15, SpS=2, mu=(2e-3, 2e-3), alg=("nlms", "dd-lms"),
                            L=(n_train, n_sym - n_train), M=16, numIter=2, backend="pallas"),
        symb_ref=d_ref)
    y = cpr(y, CPRConfig(alg="bps-pallas", M=16, N=50, B=64, Ts=1 / 32e9))
    return y[disc:-100], d_ref[disc:-100]


def _dbp_scores(y, d):
    from opticommpy_torch.comm.metrics import fast_ber_calc, monte_carlo_gmi, monte_carlo_mi

    ber, _, snr = fast_ber_calc(y, d, 16, "qam")
    gmi, _ = monte_carlo_gmi(y, d, 16, "qam")
    mi = monte_carlo_mi(y, d, 16, "qam")
    return {k: v.cpu().numpy() for k, v in dict(ber=ber, gmi=gmi, mi=mi, snr=snr).items()}


def dbp_tx_config(n_bits=2**18):
    """Path I's transmitter: 1 channel of 16-QAM polmux, 32 GBd, SpS 8, RRC
    0.01 with 1024 taps, no laser linewidth, 0 dBm."""
    from opticommpy_torch.models.tx import WDMTxConfig

    return WDMTxConfig(M=16, Rs=32e9, SpS=8, nBits=n_bits, nChannels=1, nPolModes=2,
                       nFilterTaps=1024, pulseRollOff=0.01, powerPerChannel=(0.0,),
                       laserLinewidth=0.0)


def dbp_link(sig_tx, symb_ref, fs):
    """Path I from the transmitted field on: the five launch powers as ten
    columns of one manakov_ssf call (8 x 50 km, hz 0.25 km), then per power
    the matched filter, decimation to 2 SpS and two arms, EDC and the
    launch-power rescale plus manakov_dbp (hz 5 km), each through
    :func:`_dbp_arm`. Returns the configurations, the power-scaled batch,
    each power's arm inputs, the scores per power and arm, and the SSFM's
    wall time."""
    from opticommpy_torch.dsp import EDCConfig, edc, manakov_dbp
    from opticommpy_torch.models import SSFMConfig, manakov_ssf
    from opticommpy_torch.models.tx import set_power_for_par_ssfm
    from opticommpy_torch.ops import decimate, fir_filter, pulse_shape

    cfg_ch = SSFMConfig(Ltotal=400, Lspan=50, hz=0.25, alpha=0.2, D=16, gamma=1.3,
                        Fs=fs, amp="ideal", nlprMethod=False, trapIters=1,
                        fusedLinear=True)
    cfg_dbp = SSFMConfig(Ltotal=400, Lspan=50, hz=5.0, alpha=0.2, D=16, gamma=1.3, Fs=64e9,
                         amp="ideal", nlprMethod=False, trapIters=1, fusedLinear=True)
    pulse = pulse_shape("rrc", 8, 1024, 0.01)
    sig_batch = set_power_for_par_ssfm(torch.cat([sig_tx] * len(DBP_POWERS), dim=1),
                                       DBP_POWERS)
    sig_rx_all, ssfm_s = _wall(lambda: manakov_ssf(sig_batch, cfg_ch))
    arms_in, scores = {}, {}
    for i, p_dbm in enumerate(DBP_POWERS):
        sig_dec = decimate(fir_filter(pulse, sig_rx_all[:, 2 * i:2 * i + 2]), 8, 2)
        scale = torch.sqrt(10 ** (p_dbm / 10) * 1e-3 / 2
                           / torch.mean((sig_dec * sig_dec.conj()).real))
        arms_in[p_dbm] = dict(edc=edc(sig_dec, EDCConfig(L=400, D=16, Fs=64e9, Rs=32e9)),
                              dbp=manakov_dbp(sig_dec * scale, cfg_dbp), scaled=sig_dec * scale)
        scores[p_dbm] = {arm: _dbp_scores(*_dbp_arm(arms_in[p_dbm][arm], symb_ref))
                         for arm in ("edc", "dbp")}
    return (cfg_ch, cfg_dbp), sig_batch, arms_in, scores, ssfm_s


def dbp_tx_from_jax_symbols(dev, cfg_tx):
    """Path I's transmitter (``wdm_tx_build``, no phase noise) on the JAX
    package's seed-7 symbols: the 16-QAM indices that
    ``tools/jax_dbp_reference.py --save-symbols`` wrote. Returns the field
    and the reference symbols (nSymbols, 2)."""
    from opticommpy_torch.comm.modulation import gray_mapping
    from opticommpy_torch.models.tx import wdm_tx_build

    idx = np.load(DBP_JAX_SYMBOLS)["idx"]  # (nSymbols, 2)
    const = gray_mapping(16, "qam")
    const = (const / np.sqrt(np.mean(np.abs(const) ** 2))).astype(np.complex64)
    symbols = torch.as_tensor(const[idx.T][None], device=dev)  # (1, 2, nSymbols)
    pn = torch.zeros((1, idx.shape[0] * cfg_tx.SpS), device=dev)
    sig_tx, symb_tx, _ = wdm_tx_build(symbols, pn, cfg_tx)
    return sig_tx, symb_tx[:, :, 0]


def run_dbp_path_i(dev, n_bits=2**18):
    """Path I, the DBP link of BASELINE config 5 (examples/nlc_dbp_transmission.py
    at 2**18 bits): five launch powers through one manakov_ssf call, then per
    power an EDC arm and a manakov_dbp arm, each through K2 (3 launches) and
    K1 (1). Counters reset just before and read just after."""
    from dataclasses import replace

    from opticommpy_torch.dsp import manakov_dbp
    from opticommpy_torch.models import manakov_ssf
    from opticommpy_torch.models.tx import simple_wdm_tx

    smi = _smi()
    cfg_tx = dbp_tx_config(n_bits)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    sig_tx, symb_tx, _ = simple_wdm_tx(torch.Generator(device=dev).manual_seed(7), cfg_tx)
    symb_ref = symb_tx[:, :, 0]
    (cfg_ch, cfg_dbp), sig_batch, arms_in, scores, ssfm_s = dbp_link(sig_tx, symb_ref,
                                                                     cfg_tx.Fs)
    torch.cuda.synchronize()
    counts = _counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"path I launches: {counts}")
    _check(counts == _expect(bps=2 * len(DBP_POWERS), unwrap=2 * len(DBP_POWERS),
                             mimo_eq=6 * len(DBP_POWERS)),
           f"path I launched {counts}, expected K1 and K15 x {2 * len(DBP_POWERS)} "
           f"(one per arm and power) and K2 x {6 * len(DBP_POWERS)} (one per training pass)")

    failures = []
    for p_dbm in DBP_POWERS:
        for arm in ("edc", "dbp"):
            got, ref = scores[p_dbm][arm], JAX_DBP[p_dbm][arm]
            print(f"path I {p_dbm:+.0f} dBm {arm}: BER {got['ber']} (JAX {ref['ber']}), GMI "
                  f"{got['gmi']} (JAX {ref['gmi']}), MI {got['mi']} (JAX {ref['mi']}), SNR "
                  f"{got['snr']} dB (JAX {ref['snr']})")
            for p in range(2):
                if not (np.isfinite(got["ber"][p]) and np.isfinite(got["gmi"][p])
                        and np.isfinite(got["mi"][p])):
                    failures.append(f"{p_dbm} dBm {arm} pol {p}: non-finite metric")
                if got["ber"][p] > 2 * ref["ber"][p] + 1e-4:
                    failures.append(f"{p_dbm} dBm {arm} pol {p}: BER {got['ber'][p]} above "
                                    f"2 x JAX {ref['ber'][p]} + 1e-4")
                if got["gmi"][p] < ref["gmi"][p] - 0.05:
                    failures.append(f"{p_dbm} dBm {arm} pol {p}: GMI {got['gmi'][p]} below "
                                    f"JAX {ref['gmi'][p]} - 0.05")
        gain = float(np.mean(scores[p_dbm]["dbp"]["snr"]) - np.mean(scores[p_dbm]["edc"]["snr"]))
        jax_gain = float(np.mean(JAX_DBP[p_dbm]["dbp"]["snr"])
                         - np.mean(JAX_DBP[p_dbm]["edc"]["snr"]))
        print(f"path I {p_dbm:+.0f} dBm: DBP - EDC mean SNR {gain:.4f} dB (JAX {jax_gain:.4f})")
        if jax_gain >= 0.5 and gain < 0.5:
            failures.append(f"{p_dbm} dBm: DBP beats EDC by {gain} dB, JAX by {jax_gain}")

    # the same link on the JAX package's transmitted symbols: each arm's mean
    # SNR against JAX's, which the saturated BER and GMI gates cannot see
    same = dbp_link(*dbp_tx_from_jax_symbols(dev, cfg_tx), cfg_tx.Fs)[3]
    for p_dbm in DBP_POWERS:
        for arm in ("edc", "dbp"):
            got = float(np.mean(same[p_dbm][arm]["snr"]))
            ref = float(np.mean(JAX_DBP[p_dbm][arm]["snr"]))
            print(f"path I on the JAX symbols {p_dbm:+.0f} dBm {arm}: mean SNR {got:.4f} dB "
                  f"(JAX {ref:.4f}, tolerance {SAME_SYMB_SNR_DB:g})")
            if not abs(got - ref) <= SAME_SYMB_SNR_DB:
                failures.append(f"{p_dbm} dBm {arm} on the JAX symbols: mean SNR {got} dB, "
                                f"JAX {ref} (tolerance {SAME_SYMB_SNR_DB})")

    # CUDA against the same calls on CPU tensors: a 2**14-sample prefix, one span
    fwd, back = replace(cfg_ch, Ltotal=50), replace(cfg_dbp, Ltotal=50)
    prefix = sig_batch[:2**14]
    dec_prefix = arms_in[DBP_POWERS[-1]]["scaled"][:2**14]
    rel_f = _rel(manakov_ssf(prefix, fwd), manakov_ssf(prefix.cpu(), fwd))
    rel_b = _rel(manakov_dbp(dec_prefix, back), manakov_dbp(dec_prefix.cpu(), back))
    print(f"path I prefix (2**14 samples, one span): manakov_ssf CUDA vs CPU rel {rel_f:.3e}, "
          f"manakov_dbp rel {rel_b:.3e} (tolerance {SPAN_REL:g})")
    if not (rel_f <= SPAN_REL and rel_b <= SPAN_REL):
        failures.append(f"prefix: CUDA vs CPU rel {rel_f}, {rel_b} above {SPAN_REL}")

    # warm times
    n_samples = sig_batch.shape[0] * len(DBP_POWERS)
    _, ssfm_warm = _wall(lambda: manakov_ssf(sig_batch, cfg_ch))
    dbp_ms = {p: _wall(lambda p=p: manakov_dbp(arms_in[p]["scaled"], cfg_dbp))[1] * 1e3
              for p in DBP_POWERS}
    (y, _), arm_s = _wall(lambda: _dbp_arm(arms_in[DBP_POWERS[-1]]["dbp"], symb_ref))
    n_sym = arms_in[DBP_POWERS[-1]]["dbp"].shape[0] // 2
    print(f"path I forward manakov_ssf (1,600 steps, {sig_batch.shape[0]} x "
          f"{sig_batch.shape[1]} samples): first {ssfm_s:.3f} s, warm {ssfm_warm:.3f} s, "
          f"{n_samples / ssfm_warm:.4e} samples/s over the five signals ({smi})")
    print(f"path I manakov_dbp warm ms per power (80 steps, {2 * n_sym} x 2 samples): "
          + ", ".join(f"{p:+.0f} dBm {ms:.3f}" for p, ms in dbp_ms.items()) + f" ({smi})")
    print(f"path I one arm's DSP chain warm: {arm_s * 1e3:.3f} ms, "
          f"{n_sym / arm_s / 1e6:.4f} Msym/s ({smi})")
    print(f"path I peak device memory: {peak_gib:.3f} GiB ({smi})")
    _check(not failures, "path I failed:\n  " + "\n  ".join(failures))
    return dict(counts=counts, ssfm_warm_s=ssfm_warm, dbp_ms=dbp_ms, arm_s=arm_s)


def _cuda_vs_cpu(name, fn, args, tol, dev, phase="J"):
    """Run ``fn`` on the tensors of ``args`` on the card and on the CPU; the
    largest difference over every output, relative to the output's peak (0
    for integer outputs, which must be equal)."""
    out_g = fn(*[a.to(dev) if isinstance(a, torch.Tensor) else a for a in args])
    out_c = fn(*[a.cpu() if isinstance(a, torch.Tensor) else a for a in args])
    outs_g = out_g if isinstance(out_g, tuple) else (out_g,)
    outs_c = out_c if isinstance(out_c, tuple) else (out_c,)
    err = 0.0
    for g, c in zip(outs_g, outs_c):
        _check(g.is_cuda and g.shape == c.shape, f"phase {phase} {name}: output not on the card")
        if not (g.is_floating_point() or g.is_complex()):
            err = max(err, float((g.cpu() != c).sum()))
            continue
        peak = float(c.abs().max()) or 1.0
        err = max(err, float((g.cpu() - c).abs().max()) / peak)
    print(f"phase {phase} {name}: max |CUDA - CPU| / peak {err:.3e} (tolerance {tol:g})")
    _check(err <= tol, f"phase {phase} {name}: CUDA and CPU differ by {err} (tolerance {tol})")
    return out_g


def _stat(name, got, want):
    rel = abs(got / want - 1)
    print(f"phase J {name}: {got:.6e} against {want:.6e}, relative {rel:.4f} "
          f"(tolerance {STAT_REL})")
    _check(rel <= STAT_REL, f"phase J {name}: {got} is {rel:.4f} off {want}")


def phase_single_pol(dev, n=2**20, n_sym=2**16, seed=11):
    """Phase J: the single-polarization functions at 2**20 samples or 2**16
    symbols. Deterministic ones on CUDA against the same call on CPU tensors
    (NumPy inputs from a seed); random ones by their statistics on the card;
    the scalar ssfm as a 5 x 50 km link."""
    from dataclasses import replace

    import scipy.constants as sconst

    from opticommpy_torch.comm import metrics as tmet
    from opticommpy_torch.comm import modulation as tmod
    from opticommpy_torch.comm import sources as tsrc
    from opticommpy_torch.dsp import SyncConfig, sync_data_sequences
    from opticommpy_torch.models import channels as tch
    from opticommpy_torch.models import devices as tdev
    from opticommpy_torch.models.tx import set_power_for_par_ssfm
    from opticommpy_torch.ops import fir_filter, freq_shift, pulse_shape, quantizer, symbol_sync
    from opticommpy_torch.utils import bitarray2dec, dec2bitarray

    smi = _smi()
    rng = np.random.default_rng(seed)

    def cplx(*shape):
        return torch.as_tensor(
            (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64))

    const = tmod.norm_const(16, "qam")
    ind = rng.integers(0, 16, size=(n_sym, 2))
    tx = torch.as_tensor(const[ind])
    rx = tx + 0.15 * cplx(n_sym, 2)
    x = torch.as_tensor(rng.uniform(-1.2, 1.2, size=n).astype(np.float32))
    _cuda_vs_cpu("quantizer (8 bits)", lambda a: quantizer(a, 8, 1.0, -1.0), (x,), 0.0, dev)
    sig = cplx(n, 2)
    _cuda_vs_cpu("freq_shift", lambda a: freq_shift(a, 1.3e9, 64e9), (sig,), 1e-5, dev)
    _cuda_vs_cpu("pm", lambda a, u: tdev.pm(a, u, 2.0), (sig, x[:, None].repeat(1, 2)), 1e-5, dev)
    _cuda_vs_cpu("voa", lambda a: tdev.voa(a, 3.0), (sig,), 0.0, dev)
    constt = torch.as_tensor(const)
    px = tsrc.symbol_pmf(16, "qam", "maxwell-boltzmann", 0.1)
    for rule in ("MAP", "ML"):
        _cuda_vs_cpu(f"detector {rule}", lambda r, c: tmod.detector(
            r, 0.05, c, px=torch.as_tensor(px), rule=rule), (rx, constt), 1e-6, dev)
    llr = torch.as_tensor(rng.normal(scale=6.0, size=n_sym * 4).astype(np.float32))
    _cuda_vs_cpu("soft_mapper", lambda a: tmod.soft_mapper(a, 16, "qam"), (llr,), 1e-5, dev)
    _cuda_vs_cpu("soft_estimator", lambda a, c: tmod.soft_estimator(
        a.reshape(-1, 4), tmod.bit_map(16, "qam"), c), (llr, constt), 1e-5, dev)
    x_mu = torch.as_tensor((0.9 + 0.05 * rng.normal(size=n_sym)).astype(np.float32))
    x_nu = torch.as_tensor(np.abs(0.2 * rng.normal(size=n_sym)).astype(np.float32))
    _cuda_vs_cpu("calc_extr_llr", lambda a, r, m, v: tmet.calc_extr_llr(
        a, r, m, v, const, tmod.bit_map(16, "qam")), (llr, rx[:, 0], x_mu, x_nu), 1e-5, dev)
    _cuda_vs_cpu("calc_mi", lambda r, t: tmet.calc_mi(r, t, 0.045, const, np.ones(16) / 16),
                 (rx[:, 0], tx[:, 0]), 1e-5, dev)
    mi = _cuda_vs_cpu("monte_carlo_mi", lambda r, t: tmet.monte_carlo_mi(r, t, 16, "qam"),
                      (rx, tx), 1e-5, dev)
    print(f"phase J monte_carlo_mi at 2**16 symbols, 16-QAM, SNR ~16.5 dB: {mi.cpu().numpy()}")
    # symbol_sync 'real': swapped modes, a quarter turn, a conjugate, delays
    rx_sync = torch.stack([1j * torch.roll(rx[:, 1], 17), torch.roll(rx[:, 0], -5).conj()], 1)
    rx_sync = rx_sync.repeat_interleave(2, dim=0)
    synced = _cuda_vs_cpu("symbol_sync real", lambda r, t: symbol_sync(r, t, 2, mode="real"),
                          (rx_sync, tx), 0.0, dev)
    _check(float(torch.mean(torch.abs(synced - rx_sync[::2].to(dev)) ** 2)) < 0.1,
           "phase J symbol_sync real: the synchronized reference is not the received one")
    # sync_data_sequences: 4-PAM at SpS 2, the reception 1.5 x the reference
    pam = torch.as_tensor(rng.choice([-3.0, -1.0, 1.0, 3.0], size=(n_sym, 1)).astype(np.float32))
    up = torch.zeros((2 * n_sym, 1))
    up[::2] = pam
    wave = fir_filter(pulse_shape("rrc", 2, 64, 0.2), up)
    rx_pam = torch.roll(torch.cat([wave, wave[: n_sym]]), 37, 0)
    rx_pam = rx_pam + 0.01 * torch.as_tensor(rng.normal(size=rx_pam.shape).astype(np.float32))
    for ref_kind, ref in (("symbols", pam), ("signal", wave)):
        cfg = SyncConfig(SpS=2, reference=ref_kind, syncMode="amp", rollOff=0.2, nFilterTaps=64)
        _cuda_vs_cpu(f"sync_data_sequences {ref_kind}",
                     lambda r, t, cfg=cfg: sync_data_sequences(r, t, cfg), (rx_pam, ref), 1e-5,
                     dev)
    cz_g = tsrc.cazac_sequence(n_sym, 3, device=dev)
    cz_c = tsrc.cazac_sequence(n_sym, 3, device="cpu")
    k = np.arange(n_sym, dtype=np.float64)
    exact = torch.as_tensor(np.exp(-1j * np.pi * 3 * k * (k + 1) / n_sym))
    cz_err = float((cz_g.cpu().to(torch.complex128) - exact).abs().max())
    print(f"phase J cazac_sequence (N 2**16, M 3): CUDA == CPU "
          f"{bool(torch.equal(cz_g.cpu(), cz_c))}, max |seq - float64 exact| {cz_err:.3e} "
          "(tolerance 1e-6)")
    _check(torch.equal(cz_g.cpu(), cz_c) and cz_err <= 1e-6, "phase J cazac_sequence")
    ints = torch.as_tensor(rng.integers(0, 2**16, size=n_sym))
    _cuda_vs_cpu("dec2bitarray / bitarray2dec", lambda a: (
        dec2bitarray(a, 16), bitarray2dec(dec2bitarray(a, 16).T)), (ints,), 0.0, dev)
    _check(torch.equal(bitarray2dec(dec2bitarray(ints.to(dev), 16).T).cpu(), ints.to(torch.int32)),
           "phase J bit arrays do not round-trip")
    _cuda_vs_cpu("set_power_for_par_ssfm", lambda a: set_power_for_par_ssfm(
        a, [-2.0, 0.0, 2.0, 4.0, 6.0]), (cplx(n, 10),), 1e-6, dev)

    # random functions, by their statistics on the card
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_draw = 2**24
    for dist in ("uniform", "maxwell-boltzmann"):
        sym = tsrc.symbol_source(gen, n_draw, 16, "qam", dist, 0.1)
        px = tsrc.symbol_pmf(16, "qam", dist, 0.1)
        c = tsrc.constellation(16, "qam")
        c = torch.as_tensor((c / np.sqrt(np.sum(px * np.abs(c) ** 2))).astype(np.complex64),
                            device=dev)
        freq = torch.bincount(torch.argmin((sym[:, None] - c).abs(), dim=1), minlength=16)
        rel = np.abs(freq.cpu().numpy() / n_draw / px - 1).max()
        print(f"phase J symbol_source {dist}: largest |frequency / px - 1| {rel:.5f} over 16 "
              f"points, 2**24 symbols (tolerance 0.01)")
        _check(rel <= 0.01, f"phase J symbol_source {dist}: frequencies off px by {rel}")
    sig_g = sig.to(dev)
    awgn_cfg = tch.AWGNConfig(snr=12.0, Fs=2.0, B=1.0)
    noise = tch.awgn(sig_g, gen, awgn_cfg) - sig_g
    _stat("awgn noise variance", float(torch.mean(noise.abs() ** 2)),
          2.0 * float(torch.mean(sig_g.abs() ** 2)) / 10**1.2)
    zeros = torch.zeros(n, dtype=torch.complex64, device=dev)
    acfg = tdev.ADCConfig(nBits=10, ENOB=6.0, AAF=False)
    got = tdev.adc(zeros, acfg, gen) - tdev.adc(zeros, tdev.ADCConfig(nBits=10, ENOB=10,
                                                                        AAF=False))
    _stat("adc ENOB noise variance (per axis)", float(torch.var(got.real)),
          4.0 / 12 * (2.0**-12 - 2.0**-20))
    ramp = torch.linspace(-1.0, 1.0, n, device=dev)
    # jitter of 200 sample periods on a ramp: the error is slope x jitter
    got = tdev.adc(ramp, tdev.ADCConfig(nBits=16, ENOB=16, jitter=200.0, AAF=False), gen) \
        - tdev.adc(ramp, tdev.ADCConfig(nBits=16, ENOB=16, AAF=False))
    _stat("adc jitter error variance", float(torch.var(got[2000:-2000])), (200.0 * 2.0 / n) ** 2)
    got = tdev.dac(ramp, tdev.DACConfig(nBits=12, ENOB=6.0, AIF=False), gen) \
        - tdev.dac(ramp, tdev.DACConfig(nBits=12, ENOB=12, AIF=False))
    _stat("dac ENOB noise variance", float(torch.var(got)), 4.0 / 12 * (2.0**-12 - 2.0**-24))
    got = tdev.dac(ramp, tdev.DACConfig(nBits=16, ENOB=16, jitter=200.0, AIF=False), gen) \
        - tdev.dac(ramp, tdev.DACConfig(nBits=16, ENOB=16, AIF=False))
    _stat("dac jitter error variance", float(torch.var(got[2000:-2000])), (200.0 * 2.0 / n) ** 2)
    edfa_cfg = tch.SSFMConfig(Ltotal=250, Lspan=50, hz=0.5, alpha=0.2, D=16, gamma=1.3,
                              Fs=64e9, amp="edfa", NF=4.5, fusedLinear=True)
    dark = tch.ssfm(torch.zeros(n, dtype=torch.complex64, device=dev), edfa_cfg, gen)
    g, nf = 10.0, 10**0.45
    p_ase = (g - 1) * (g * nf - 1) / (2 * (g - 1)) * sconst.h * edfa_cfg.Fc * edfa_cfg.Fs
    _stat("ssfm edfa ASE power per span", float(torch.mean(dark.abs() ** 2)) / 5, p_ase)

    # the scalar ssfm as a link: 2**20 samples, 5 x 50 km, hz 0.5
    link = (0.03 * cplx(n, 1))[:, 0]
    out = {}
    for fused in (True, False):
        cfg = tch.SSFMConfig(Ltotal=250, Lspan=50, hz=0.5, alpha=0.2, D=16, gamma=1.3,
                             Fs=64e9, amp="ideal", fusedLinear=fused)
        span = replace(cfg, Ltotal=50)
        rel = _rel(tch.ssfm(link.to(dev), span), tch.ssfm(link, span))
        tch.ssfm(link.to(dev), cfg)
        y, s = _wall(lambda cfg=cfg: tch.ssfm(link.to(dev), cfg))
        _check(bool(torch.isfinite(y).all()), "phase J ssfm: non-finite output")
        print(f"phase J ssfm fusedLinear={fused}: one span CUDA vs CPU rel {rel:.3e} "
              f"(tolerance {SPAN_REL:g}); 5 x 50 km warm {s * 1e3:.3f} ms, "
              f"{n / s:.4e} samples/s ({smi})")
        _check(rel <= SPAN_REL, f"phase J ssfm fusedLinear={fused}: rel {rel}")
        out[fused] = s
    return out


def _k_eq_inputs(res, n_sym=4096):
    """Phase K's equalizer input: the centre channel's first ``n_sym``
    symbols after the matched filter, decimation to 2 samples/symbol, EDC,
    normalization and 4th-power FOE (as the batch chain's front end), with
    the synchronized reference."""
    from opticommpy_torch.dsp import EDCConfig, edc, fourth_power_foe
    from opticommpy_torch.ops import decimate, fir_filter, pnorm, pulse_shape

    x = decimate(fir_filter(pulse_shape("rrc", 16, 1024, 0.01), res["sig_rx"]), 16, 2)
    x = pnorm(edc(x, EDCConfig(L=250, D=16, Fs=64e9, Rs=32e9)))
    x, _ = fourth_power_foe(x, 64e9, 4)
    return pnorm(x)[:2 * n_sym].contiguous(), res["d_ref"][:n_sym].contiguous()


def run_scan_phase_k(dev, res, sig_b, ref_b, dsp_warm_s, n_train=12000, n_eq=4096,
                     n_mlse=16384, n_white=2**20):
    """Phase K: the routes the JAX package runs outside any Pallas kernel,
    on the main path's field. K-chain: ``coherent_dsp_chain`` on the centre
    channel with blockUpdate 16 (the blocked training stages; K1 1, K2 and
    K3 none), BER <= 1e-2 and within 2 x the same chain on the CPU + 1e-4,
    GMI >= CPU - 0.05. K-batch: ``coherent_dsp_chain_batch`` over the 11
    channels, same config (K1 1, K3 none), each polarization that the same
    chain on the CPU brings below a BER of 1e-2 against it (the same
    bounds), each channel equal to the batch chain run on that channel
    alone (B = 1), the median BER within 2 x the JAX package's blocked run
    + 1e-4 (JAX_BLOCKED_WDM); whether it meets 1e-2, the JAX package's
    bound on its 100 km blocked-chain test, is printed: neither package
    does on this field at these steps. K-wl /
    K-store: ``mimo_adapt_equalizer`` with runWL (dd-lms; da-rde then
    dd-lms) and storeCoeff (nlms) at ``n_eq`` symbols, CUDA against the
    CPU. K-mlse: ``mlse`` on PAM4 through h = [1, 0.45] and 16-QAM through
    a 2-tap channel (16 states), decisions equal to the CPU's. K-whiten:
    ``estimate_whitening_filter`` at 2**20 samples and 8 taps, CUDA against
    the CPU within 1e-5 relative."""
    from opticommpy_torch.comm.modulation import gray_mapping, mlse
    from opticommpy_torch.dsp import MIMOEqualizerConfig, mimo_adapt_equalizer
    from opticommpy_torch.ops import estimate_whitening_filter
    from opticommpy_torch.pipelines import (CoherentDSPConfig, coherent_dsp_chain,
                                            coherent_dsp_chain_batch)

    out, failures = {}, []
    cfg = CoherentDSPConfig(SpS_in=16, L=250, nTrain=n_train, mu=(5e-3, 1e-3),
                            blockUpdate=16, eqBackend="pallas", cprBackend="pallas")
    disc = n_train + 2000
    # K-chain
    sig, ref = res["sig_rx"], res["d_ref"]
    n_sym = ref.shape[0]
    _reset_counts()
    (y, phases), first_s = _wall(lambda: coherent_dsp_chain(sig, ref, cfg))
    counts = _counts()
    print(f"K-chain launches: {counts}")
    _check(counts == _expect(bps=1, unwrap=1),
           f"K-chain: launches {counts}, expected K1 1, K15 1, K2 = K3 = 0")
    _check(tuple(y.shape) == (n_sym, 2) and y.is_cuda and bool(torch.isfinite(y).all())
           and bool(torch.isfinite(phases).all()), f"K-chain: unexpected output {tuple(y.shape)}")
    (y2, _), warm_s = _wall(lambda: coherent_dsp_chain(sig, ref, cfg))
    ber, gmi, evm = _scores(y, ref, disc)
    (y_cpu, _), cpu_s = _wall(lambda: coherent_dsp_chain(sig.cpu(), ref.cpu(), cfg))
    c_ber, c_gmi, _ = _scores(y_cpu, ref.cpu(), disc)
    d = (y.cpu() - y_cpu).abs()
    print(f"K-chain (blockUpdate 16, {n_sym} symbols): first {first_s * 1e3:.1f} ms, warm "
          f"{warm_s * 1e3:.1f} ms, {n_sym / warm_s / 1e6:.4f} Msym/s (per-symbol chain warm "
          f"{dsp_warm_s * 1e3:.1f} ms, {n_sym / dsp_warm_s / 1e6:.4f} Msym/s); twice "
          f"bit-identical {bool(torch.equal(y, y2))}; BER {ber} (CPU {c_ber}), GMI {gmi} "
          f"(CPU {c_gmi}), EVM {evm}; the CPU run {cpu_s:.1f} s, CUDA vs CPU max |diff| "
          f"{float(d.max()):.3e}, share > 1e-3 {float((d > 1e-3).float().mean()):.2e}")
    for p in range(2):
        if not (ber[p] <= 1e-2 and ber[p] <= 2 * c_ber[p] + 1e-4 and gmi[p] >= c_gmi[p] - 0.05):
            failures.append(f"K-chain pol {p}: BER {ber[p]:.3e} GMI {gmi[p]:.4f} vs CPU "
                            f"{c_ber[p]:.3e} {c_gmi[p]:.4f} (BER bound 1e-2)")
    out["chain"] = dict(counts=counts, first_ms=first_s * 1e3, warm_ms=warm_s * 1e3,
                        msym_s=n_sym / warm_s / 1e6, ber=ber.tolist(), gmi=gmi.tolist(),
                        cpu_ber=c_ber.tolist(), cpu_gmi=c_gmi.tolist())
    # K-batch
    n_ch = sig_b.shape[0]
    _reset_counts()
    (yb, phb), first_s = _wall(lambda: coherent_dsp_chain_batch(sig_b, ref_b, cfg))
    counts = _counts()
    print(f"K-batch launches: {counts}")
    _check(counts == _expect(bps=1, unwrap=1),
           f"K-batch: launches {counts}, expected K1 1, K15 1, K3 0")
    _check(tuple(yb.shape) == tuple(ref_b.shape) and bool(torch.isfinite(yb).all())
           and tuple(phb.shape) == (ref_b.shape[1], 2 * n_ch),
           f"K-batch: unexpected output {tuple(yb.shape)}")
    (_, _), warm_s = _wall(lambda: coherent_dsp_chain_batch(sig_b, ref_b, cfg))
    rows = [_scores(yb[k], ref_b[k], disc) for k in range(n_ch)]
    med_ber = float(np.median([r[0] for r in rows]))
    med_gmi = float(np.median([r[1] for r in rows]))
    # the same chain on the same input on the CPU: the per-channel reference
    (yb_cpu, _), cpu_s = _wall(lambda: coherent_dsp_chain_batch(sig_b.cpu(), ref_b.cpu(), cfg))
    cpu_rows = [_scores(yb_cpu[k], ref_b[k].cpu(), disc) for k in range(n_ch)]
    # every channel against the same chain on that channel alone (B = 1):
    # the equalized symbols within 1e-4 on all but 0.1% of them (a BPS
    # near-tie turns a symbol by pi/128), the tolerance of the chain tests
    alone = []
    for k in range(n_ch):
        y1, _ = coherent_dsp_chain_batch(sig_b[k:k + 1], ref_b[k:k + 1], cfg)
        dk = (y1[0] - yb[k]).abs()
        alone.append((float((dk > 1e-4).float().mean()), float(dk.max())))
    n_ok = sum(int(b < 1e-3) for r in rows for b in r[0])
    n_ok_jax = sum(int(b < 1e-3) for r in JAX_BLOCKED_WDM["ber"][:n_ch] for b in r)
    print(f"K-batch ({n_ch} channels): first {first_s * 1e3:.1f} ms, warm {warm_s * 1e3:.1f} "
          f"ms, {n_ch * ref_b.shape[1] / warm_s / 1e6:.4f} Msym/s aggregate; the CPU run "
          f"{cpu_s:.1f} s; median BER {med_ber:.3e} (JAX {JAX_BLOCKED_WDM['median_ber']:.3e}; "
          f"1e-2 met: {med_ber <= 1e-2}), median GMI {med_gmi:.4f} (JAX "
          f"{JAX_BLOCKED_WDM['median_gmi']:.4f}); polarizations with BER < 1e-3: {n_ok} of "
          f"{2 * n_ch} (JAX {n_ok_jax})")
    # per polarization against the CPU where the CPU run converged (BER <
    # 1e-2); an unconverged one wanders, so float32 rounding alone moves its
    # BER between runs of different devices (0.15 against 0.46 seen)
    for k, ((ber_k, gmi_k, _), (c_ber, c_gmi, _)) in enumerate(zip(rows, cpu_rows)):
        print(f"  K-batch ch {k:2d}: BER {ber_k[0]:.3e} {ber_k[1]:.3e} (CPU {c_ber[0]:.3e} "
              f"{c_ber[1]:.3e}), GMI {gmi_k[0]:.4f} {gmi_k[1]:.4f} (CPU {c_gmi[0]:.4f} "
              f"{c_gmi[1]:.4f})")
        for p in range(2):
            if c_ber[p] < 1e-2 and not (ber_k[p] <= 2 * c_ber[p] + 1e-4
                                        and gmi_k[p] >= c_gmi[p] - 0.05):
                failures.append(f"K-batch ch {k} pol {p}: BER {ber_k[p]:.3e} GMI "
                                f"{gmi_k[p]:.4f} vs CPU {c_ber[p]:.3e} {c_gmi[p]:.4f}")
    print("K-batch against each channel alone (share > 1e-4, max |diff|): "
          + ", ".join(f"ch {k} {a:.1e} {m:.1e}" for k, (a, m) in enumerate(alone)))
    # against the JAX package's blocked run on its own realization: the
    # median BER within the WDM paths' bound. The median GMI is printed, not
    # held: each polarization converges or not (JAX_BLOCKED_WDM), so the
    # median falls between the two groups, where GMI moves by ~1 bit between
    # neighbouring polarizations.
    if not med_ber <= 2 * JAX_BLOCKED_WDM["median_ber"] + 1e-4:
        failures.append(f"K-batch: median BER {med_ber:.3e} above 2 x JAX "
                        f"{JAX_BLOCKED_WDM['median_ber']:.3e} + 1e-4")
    for k, (share, dmax) in enumerate(alone):
        if not (share <= 1e-3 and dmax < 0.05):
            failures.append(f"K-batch ch {k}: differs from the channel alone ({share:.2e}, "
                            f"{dmax:.3e})")
    out["batch"] = dict(counts=counts, first_ms=first_s * 1e3, warm_ms=warm_s * 1e3,
                        median_ber=med_ber, median_gmi=med_gmi)
    # K-wl / K-store: the per-symbol scan routes, CUDA against the CPU
    x, d_ref = _k_eq_inputs(res, n_eq)
    half = n_eq // 2
    cases = {
        "wl dd-lms": MIMOEqualizerConfig(nTaps=15, SpS=2, mu=(1e-3,), alg=("dd-lms",), M=16,
                                         runWL=True, backend="pallas"),
        "wl da-rde/dd-lms": MIMOEqualizerConfig(nTaps=15, SpS=2, mu=(5e-3, 1e-3),
                                                alg=("da-rde", "dd-lms"), L=(half, half),
                                                M=16, runWL=True, backend="pallas"),
        "store nlms": MIMOEqualizerConfig(nTaps=15, SpS=2, mu=(2e-3,), alg=("nlms",), M=16,
                                          storeCoeff=True, backend="pallas"),
    }
    out["scan_ms"] = {}
    for name, eq_cfg in cases.items():
        _reset_counts()
        r_g, g_s = _wall(lambda: mimo_adapt_equalizer(x, eq_cfg, symb_ref=d_ref,
                                                      return_results=True))
        counts = _counts()
        r_c, c_s = _wall(lambda: mimo_adapt_equalizer(x.cpu(), eq_cfg, symb_ref=d_ref.cpu(),
                                                      return_results=True))
        errs = [float((a.cpu() - b).abs().max()) for a, b in zip(r_g, r_c)]
        ok = (errs[0] < EQ_Y_ATOL and errs[1] < EQ_H_ATOL and errs[2] < EQ_H_ATOL
              and errs[3] < EQ_Y_ATOL and errs[4] < EQ_H_ATOL)
        hiter = r_g[4]
        if eq_cfg.storeCoeff:
            ok = ok and tuple(hiter.shape) == (n_eq, 2, 2, 15) and bool(torch.equal(hiter[-1],
                                                                                    r_g[1]))
        print(f"K-{name}: {g_s * 1e3:.1f} ms on CUDA ({g_s * 1e6 / n_eq:.1f} us/symbol), "
              f"{c_s * 1e3:.1f} ms on the CPU; launches {counts}; CUDA vs CPU max |diff| "
              f"y {errs[0]:.2e} H {errs[1]:.2e} H_ {errs[2]:.2e} errSq {errs[3]:.2e} Hiter "
              f"{errs[4]:.2e}; Hiter {tuple(hiter.shape)}")
        _check(counts == _expect(), f"K-{name}: a kernel launched on a scan route: {counts}")
        if not ok:
            failures.append(f"K-{name}: CUDA differs from the CPU {errs}")
        out["scan_ms"][name] = dict(cuda_ms=g_s * 1e3, cpu_ms=c_s * 1e3,
                                    us_per_symbol=g_s * 1e6 / n_eq)
    # K-mlse
    rng = np.random.default_rng(13)
    for name, M, ctype, h, noise, ser_max in (
            ("pam4 L1", 4, "pam", [1.0, 0.45], 0.01, 2e-2),
            ("16qam L1", 16, "qam", [1.0, 0.3 + 0.1j], 0.05, 1e-2)):
        c = gray_mapping(M, ctype)
        c = c / np.sqrt(np.mean(np.abs(c) ** 2))
        xs = c[rng.integers(0, M, size=n_mlse)]
        ys = np.convolve(xs, h)[:n_mlse] + noise * rng.normal(size=n_mlse)
        if ctype == "qam":
            ys = ys + 1j * noise * rng.normal(size=n_mlse)
        y_t = torch.as_tensor(ys.astype(np.complex64 if ctype == "qam" else np.float32))
        dec_g, g_s = _wall(lambda: mlse(y_t.to(dev), np.array(h), c))
        dec_c, c_s = _wall(lambda: mlse(y_t, np.array(h), c))
        same = bool(torch.equal(dec_g.cpu(), dec_c))
        ser = float(np.mean(np.abs(dec_g.cpu().numpy()[:-5] - xs[:-5]) > 1e-3))
        print(f"K-mlse {name} ({M ** (len(h) - 1)} states, {n_mlse} symbols): "
              f"{g_s * 1e3:.1f} ms on CUDA ({g_s * 1e6 / n_mlse:.1f} us/symbol), "
              f"{c_s * 1e3:.1f} ms on the CPU; decisions equal {same}; SER {ser:.2e}")
        if not (same and ser < ser_max and dec_g.is_cuda):
            failures.append(f"K-mlse {name}: equal {same}, SER {ser:.2e} (bound {ser_max})")
        out["scan_ms"][f"mlse {name}"] = dict(cuda_ms=g_s * 1e3, cpu_ms=c_s * 1e3,
                                              us_per_symbol=g_s * 1e6 / n_mlse)
    # K-whiten
    w = np.convolve(rng.normal(size=n_white), [1.0, 0.7, 0.3], mode="same").astype(np.float32)
    w_t = torch.as_tensor(w)
    a_g, g_s = _wall(lambda: estimate_whitening_filter(w_t.to(dev), 8))
    a_c, c_s = _wall(lambda: estimate_whitening_filter(w_t, 8))
    rel = float((a_g.cpu() - a_c).abs().max() / a_c.abs().max())
    print(f"K-whiten (2**{int(np.log2(n_white))} samples, 8 taps): {g_s * 1e3:.1f} ms on CUDA "
          f"(input on the card), {c_s * 1e3:.1f} ms on the CPU; rel. diff {rel:.2e}")
    if not (rel < 1e-5 and a_g.is_cuda):
        failures.append(f"K-whiten: CUDA vs CPU rel. diff {rel:.2e}")
    out["scan_ms"]["whiten"] = dict(cuda_ms=g_s * 1e3, cpu_ms=c_s * 1e3)
    _check(not failures, "phase K failed:\n  " + "\n  ".join(failures))
    return out


# ---------------------------------------------------------------------------
# Path L: the Giles-EDFA link of BASELINE config 4
# ---------------------------------------------------------------------------

FC_L = 193.1e12
EDFA_PREFIX_REL = 1e-6  # path L: edfa_sm on CUDA vs CPU tensors, noise zeroed, relative
# The JAX package (0.9.0) on the CPU at path L's configuration, seed 11: per span
# the gain [dB] and the forward pump [W] after AGC; per polarization BER, GMI and
# SNR [dB] after the first 2,500 and before the last 64 symbols:
# JAX_PLATFORMS=cpu python tools/jax_edfa_link_reference.py (266 s on 8 CPU cores)
JAX_EDFA = dict(
    gain_db=(9.84553882748379, 9.937678977915931, 9.974815028257781),
    pump_f_w=(0.004792978825255111, 0.004869073430320305, 0.004899876269248503),
    ber=(0.0002302610664628446, 0.0001707108021946624),
    gmi=(3.995734453201294, 3.9967918395996094),
    snr=(18.095914840698242, 18.27935028076172),
)


def edfa_link_configs(n_bits=2**18, n_channels=11):
    """Path L's transmitter, span and amplifier (examples/wdm_amp_transmission.py
    at the main path's widths): 16-QAM polmux, 32 GBd, SpS 16, 37.5 GHz grid,
    -2 dBm per channel, 100 kHz lasers; 50 km of manakov_ssf without gain
    (nlprMethod, maxNlinPhaseRot 2e-2); edfa_sm AGC 10 dB, 8 m of the synthetic
    EDF, 60 mW forward pump, no backward pump, 100 GHz noise band, tolCtrl 0.5."""
    from opticommpy_torch.models import SSFMConfig
    from opticommpy_torch.models.amplification import EDFASMConfig
    from opticommpy_torch.models.tx import WDMTxConfig

    cfg_tx = WDMTxConfig(M=16, Rs=32e9, SpS=16, nBits=n_bits, nChannels=n_channels,
                         nPolModes=2, nFilterTaps=1024, pulseRollOff=0.01,
                         powerPerChannel=(-2.0,), wdmGridSpacing=37.5e9,
                         laserLinewidth=100e3)
    cfg_span = SSFMConfig(Ltotal=50, Lspan=50, alpha=0.2, D=16, gamma=1.3, Fs=cfg_tx.Fs,
                          amp="none", nlprMethod=True, maxNlinPhaseRot=2e-2)
    cfg_edfa = EDFASMConfig(type="AGC", value=10.0, lngth=8.0, forPumpW=(60e-3,),
                            bckPumpW=(0.0,), noiseBand=100e9, tolCtrl=0.5)
    return cfg_tx, cfg_span, cfg_edfa


def _timed_edfa(sig, fs, cfg, gen):
    """edfa_sm on ``sig``, with the seconds of its host solver (the
    boundary-value ODE and the PID loop) and of the rest (FFTs, transfers,
    noise on the card)."""
    from unittest import mock

    from opticommpy_torch.models import amplification as amp

    host = []
    solve = amp._solve_giles

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = solve(*args, **kw)
        host.append(time.perf_counter() - t0)
        return out

    with mock.patch.object(amp, "_solve_giles", timed):
        out, wall = _wall(lambda: amp.edfa_sm(sig, fs, FC_L, cfg, generator=gen))
    return out, host[0], wall - host[0]


def run_edfa_path_l(dev, n_bits=2**18, n_channels=11, n_train=2000):
    """Path L, the Giles-EDFA link of BASELINE config 4: simple_wdm_tx, then 3 x
    (50 km manakov_ssf, edfa_sm), then the centre channel's receiver:
    pdm_coherent_receiver, a 0.6 Rs low-pass, the matched filter, decimation
    to 2 SpS, edc over 150 km, symbol_sync, mimo_adapt_equalizer (da-rde /
    dd-lms, numIter 2: K2 3 launches) and cpr BPS (K1 1). Counters reset just
    before and read just after."""
    from unittest import mock

    from torch.profiler import ProfilerActivity, profile

    from opticommpy_torch.comm.metrics import fast_ber_calc, monte_carlo_gmi
    from opticommpy_torch.kernels import ssfm_pass
    from opticommpy_torch.models import LaserConfig, basic_laser_model, manakov_ssf
    from opticommpy_torch.models import amplification as amp
    from opticommpy_torch.models.tx import simple_wdm_tx
    from opticommpy_torch.utils import profiling

    smi = _smi()
    cfg_tx, cfg_span, cfg_edfa = edfa_link_configs(n_bits, n_channels)
    fs = cfg_tx.Fs
    failures, spans = [], []
    _reset_counts()
    profiling.reset_counts()
    k16_before = ssfm_pass.launches
    gen = torch.Generator(device=dev).manual_seed(11)
    sig, symb_tx, grid = simple_wdm_tx(gen, cfg_tx)
    span_in = None
    for n in range(3):
        with profile(activities=[ProfilerActivity.CPU]):  # the solver's step and pass counters
            sig_in, ssfm_s = _wall(lambda: manakov_ssf(sig, cfg_span))
        (out, pump_f, _, noise_amp), host_s, dev_s = _timed_edfa(sig_in, fs, cfg_edfa, gen)
        _check(out.is_cuda and pump_f.is_cuda and noise_amp.is_cuda,
               "path L: edfa_sm returned a tensor off the card")
        gain = 10 * float(torch.log10(torch.mean(out.abs() ** 2)
                                      / torch.mean(sig_in.abs().double() ** 2)))
        spans.append(dict(ssfm_s=ssfm_s, host_s=host_s, dev_s=dev_s, gain_db=gain,
                          pump_f_w=float(pump_f[0])))
        print(f"path L span {n + 1}: SSFM {ssfm_s:.3f} s, edfa_sm host ODE {host_s:.3f} s, "
              f"device and transfers {dev_s:.3f} s; gain {gain:.4f} dB (JAX "
              f"{JAX_EDFA['gain_db'][n]:.4f}); forward pump {1e3 * float(pump_f[0]):.4f} mW "
              f"(JAX {1e3 * JAX_EDFA['pump_f_w'][n]:.4f}) ({smi})")
        if not abs(gain - cfg_edfa.value) <= cfg_edfa.tolCtrl:
            failures.append(f"span {n + 1}: gain {gain} dB not within {cfg_edfa.tolCtrl} dB "
                            f"of {cfg_edfa.value}")
        if n == 0:
            span_in, amp_1 = sig_in, noise_amp
        sig = out.to(torch.complex64)

    centre = cfg_tx.nChannels // 2
    lo = basic_laser_model(LaserConfig(P=10.0, lw=100e3, Ns=sig.shape[0], Fs=fs,
                                       freqShift=float(grid[centre]) + 80e6, RIN_var=0.0), gen)
    (y, d_ref), rx_s = _wall(lambda: _edfa_receiver(sig, lo, symb_tx[:, :, centre], cfg_tx,
                                                    n_train, gen))
    torch.cuda.synchronize()
    counts = _counts()
    k16 = ssfm_pass.launches - k16_before
    solver = profiling.counts()
    steps, passes = solver.get("ssfm.steps", 0.0), solver.get("ssfm.trap_iters", 0.0)
    print(f"path L launches: {counts}, K16 {k16} (replays counted; the solver's {steps:.0f} "
          f"steps and {passes:.0f} passes: 2 x steps + 3 x passes = {2 * steps + 3 * passes:.0f})")
    _check(counts == _expect(bps=1, unwrap=1, mimo_eq=3),
           f"path L launched {counts}, expected K1 x 1, K15 x 1 and K2 x 3")
    _check(steps > 0 and k16 == 2 * steps + 3 * passes
           and solver.get("ssfm.fused_passes", 0.0) == passes,
           "path L: the adaptive spans' K16 launches are not 2 a step and 3 a pass")
    _check(bool(torch.isfinite(y).all()) and y.is_cuda, "path L: non-finite or off-card output")
    disc = n_train + 500
    yy, dd = y[disc:-64], d_ref[disc:-64]
    ber, _, snr = (t.cpu().numpy() for t in fast_ber_calc(yy, dd, 16, "qam"))
    gmi = monte_carlo_gmi(yy, dd, 16, "qam")[0].cpu().numpy()
    print(f"path L centre channel after 150 km: BER {ber} (JAX {JAX_EDFA['ber']}), GMI {gmi} "
          f"(JAX {JAX_EDFA['gmi']}), SNR {snr} dB (JAX {JAX_EDFA['snr']}); receiver "
          f"{rx_s:.3f} s first call ({smi})")
    for p in range(2):
        if not ber[p] <= 2 * JAX_EDFA["ber"][p] + 1e-4:
            failures.append(f"pol {p}: BER {ber[p]} above 2 x JAX {JAX_EDFA['ber'][p]} + 1e-4")
        if not gmi[p] >= JAX_EDFA["gmi"][p] - 0.05:
            failures.append(f"pol {p}: GMI {gmi[p]} below JAX {JAX_EDFA['gmi'][p]} - 0.05")

    # the ASE draw on the card against its model, at span 1's noise amplitude
    draw = amp._ase_noise(amp_1, torch.Generator(device=dev).manual_seed(5))
    on = amp_1 > 0
    ratio = float(torch.mean(draw.abs()[on] ** 2 / amp_1[on] ** 2))
    print(f"path L ASE draw: mean |noise|^2 / noise_amp^2 over {int(on.sum())} bins "
          f"{ratio:.5f} (tolerance {STAT_REL})")
    if not abs(ratio - 1) <= STAT_REL:
        failures.append(f"ASE variance per bin {ratio} of noise_amp**2")

    # CUDA against CPU tensors on a 2**16-sample prefix of span 1's input, noise zeroed
    prefix = span_in[:2**16]

    def no_ase(noise_amp, generator):
        return torch.zeros(noise_amp.shape, dtype=torch.complex128, device=noise_amp.device)

    with mock.patch.object(amp, "_ase_noise", no_ase):
        got = amp.edfa_sm(prefix, fs, FC_L, cfg_edfa)
        want = amp.edfa_sm(prefix.cpu(), fs, FC_L, cfg_edfa)
    rels = {k: _rel(g, w) for k, g, w in zip(("e_out", "pump_f", "pump_b", "noise_amp"),
                                             got, want) if float(w.abs().max()) > 0}
    print(f"path L edfa_sm on a 2**16 prefix, CUDA vs CPU, noise zeroed: "
          + ", ".join(f"{k} rel {v:.3e}" for k, v in rels.items())
          + f" (tolerance {EDFA_PREFIX_REL:g})")
    if not all(g.is_cuda for g in got) or max(rels.values()) > EDFA_PREFIX_REL:
        failures.append(f"prefix CUDA vs CPU: {rels}")
    _check(not failures, "path L failed:\n  " + "\n  ".join(failures))
    return dict(counts=counts, spans=spans, ber=ber, gmi=gmi, rx_s=rx_s, k16_launches=k16,
                ssfm_steps=steps, ssfm_passes=passes)


def _edfa_receiver(sig, lo, symb_ref, cfg_tx, n_train, gen):
    """Path L's receiver of the centre channel; (y, synchronized reference)."""
    from opticommpy_torch.dsp import (CPRConfig, EDCConfig, MIMOEqualizerConfig, cpr, edc,
                                      mimo_adapt_equalizer)
    from opticommpy_torch.models import PDMFrontendConfig, pdm_coherent_receiver
    from opticommpy_torch.ops import (decimate, fir_filter, lowpass_fir, pnorm, pulse_shape,
                                      symbol_sync)

    fs, rs = cfg_tx.Fs, cfg_tx.Rs
    rx = pdm_coherent_receiver(sig, lo, PDMFrontendConfig(Fs=fs), generator=gen)
    rx = fir_filter(lowpass_fir(0.6 * rs, fs, 501), rx)
    dec = decimate(fir_filter(pulse_shape("rrc", cfg_tx.SpS, 1024, cfg_tx.pulseRollOff), rx),
                   cfg_tx.SpS, 2)
    cd = edc(dec, EDCConfig(L=150, D=16, Fs=2 * rs, Rs=rs))
    d_ref = pnorm(symbol_sync(cd, symb_ref, 2))
    n_sym = d_ref.shape[0]
    y = mimo_adapt_equalizer(
        pnorm(cd),
        MIMOEqualizerConfig(nTaps=15, SpS=2, mu=(5e-3, 2e-3), alg=("da-rde", "dd-lms"),
                            L=(n_train, n_sym - n_train), M=16, numIter=2, backend="pallas"),
        symb_ref=d_ref)
    return cpr(y, CPRConfig(alg="bps-pallas", M=16, N=35, B=64, Ts=1 / rs)), d_ref


# ---------------------------------------------------------------------------
# Path M: the perturbation-NLC link
# ---------------------------------------------------------------------------

PERT_POWERS = (-2.0, -0.5, 1.0, 2.5, 4.0)
PERT_ARMS = ("edc", "nlc", "nlc_ideal")
# path M: an EDC BER above this on both polarizations means the linear receiver
# lost the signal (the JAX run at 4 dBm: BER 0.445 / 0.439, mean SNR -2.1 dB)
PERT_LOST_BER = 0.1
PERT_JAX_SYMBOLS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                                "pert_jax_seed7_symbols.npz")
# The JAX package (0.9.0) on the CPU at path M's configuration, on the seed-7
# symbols of tools/pert_jax_seed7_symbols.npz: per launch power [dBm] and arm, per
# polarization, BER and SNR [dB] after the first 5,000 and before the last 100
# symbols: JAX_PLATFORMS=cpu python tools/jax_pert_nlc_reference.py (927 s on 8 CPU
# cores). At 4 dBm the linear receiver loses the signal in the JAX run (BER ~0.44)
JAX_PERT = {
    -2.0: {
        "edc": dict(
            ber=(7.510407158406451e-05, 5.185757254366763e-05),
            snr=(26.229106903076172, 26.238262176513672),
        ),
        "nlc": dict(
            ber=(7.510407158406451e-05, 5.185757254366763e-05),
            snr=(26.520423889160156, 26.532222747802734),
        ),
        "nlc_ideal": dict(
            ber=(0.003301002783700824, 0.0008726377855055034),
            snr=(21.551210403442383, 23.217803955078125),
        ),
    },
    -0.5: {
        "edc": dict(
            ber=(0.0010729152709245682, 0.0009262835374101996),
            snr=(23.672420501708984, 23.693683624267578),
        ),
        "nlc": dict(
            ber=(0.0011068909661844373, 0.0009584710351191461),
            snr=(24.5374698638916, 24.599376678466797),
        ),
        "nlc_ideal": dict(
            ber=(0.0037748736795037985, 0.002321073552593589),
            snr=(21.24875259399414, 22.01702308654785),
        ),
    },
    1.0: {
        "edc": dict(
            ber=(0.007140251342207193, 0.006884539965540171),
            snr=(20.78021812438965, 20.81660270690918),
        ),
        "nlc": dict(
            ber=(0.007395963184535503, 0.007129522506147623),
            snr=(21.288766860961914, 21.35504722595215),
        ),
        "nlc_ideal": dict(
            ber=(0.004007338546216488, 0.004908587783575058),
            snr=(21.093233108520508, 20.921850204467773),
        ),
    },
    2.5: {
        "edc": dict(
            ber=(0.02997904270887375, 0.03670979663729668),
            snr=(17.39727020263672, 14.751871109008789),
        ),
        "nlc": dict(
            ber=(0.030122097581624985, 0.03684927523136139),
            snr=(17.4288330078125, 14.763498306274414),
        ),
        "nlc_ideal": dict(
            ber=(0.007637368980795145, 0.006237214431166649),
            snr=(20.040508270263672, 20.48653793334961),
        ),
    },
    4.0: {
        "edc": dict(
            ber=(0.44540828466415405, 0.4385201632976532),
            snr=(-2.264057159423828, -1.9832663536071777),
        ),
        "nlc": dict(
            ber=(0.44653305411338806, 0.4390709400177002),
            snr=(-2.244807720184326, -1.9660629034042358),
        ),
        "nlc_ideal": dict(
            ber=(0.08617298305034637, 0.09113521873950958),
            snr=(13.594808578491211, 13.35318660736084),
        ),
    },
}


def pert_tx_config(n_symbols=98_304):
    """Path M's transmitter: 1 channel of 64-QAM polmux, 32 GBd, SpS 8, RRC 0.01
    with 1024 taps, no laser linewidth, 0 dBm."""
    from opticommpy_torch.models.tx import WDMTxConfig

    return WDMTxConfig(M=64, Rs=32e9, SpS=8, nBits=6 * n_symbols, nChannels=1, nPolModes=2,
                       nFilterTaps=1024, pulseRollOff=0.01, powerPerChannel=(0.0,),
                       laserLinewidth=0.0)


def pert_tx_from_jax_symbols(dev, cfg_tx):
    """Path M's transmitter (``wdm_tx_build``, no phase noise) on the JAX
    package's seed-7 64-QAM indices; (field, reference symbols (nSymbols, 2))."""
    from opticommpy_torch.comm.modulation import norm_const
    from opticommpy_torch.models.tx import wdm_tx_build

    idx = np.load(PERT_JAX_SYMBOLS)["idx"][:cfg_tx.nSymbols]
    symbols = torch.as_tensor(norm_const(64, "qam")[idx.T][None], device=dev)
    pn = torch.zeros((1, idx.shape[0] * cfg_tx.SpS), device=dev)
    sig_tx, symb_tx, _ = wdm_tx_build(symbols, pn, cfg_tx)
    return sig_tx, symb_tx[:, :, 0]


def _pert_rx(sig_rx, symb_ref, n_train=4000, disc=5000):
    """Path M's linear receiver (examples/perturbation_nlc.py): matched filter,
    decimation to 2 SpS, EDC over 800 km, symbol_sync, the equalizer on K2
    (nlms twice, then dd-lms) and BPS on K1; (y, d) after the discarded symbols."""
    from opticommpy_torch.dsp import (CPRConfig, EDCConfig, MIMOEqualizerConfig, cpr, edc,
                                      mimo_adapt_equalizer)
    from opticommpy_torch.ops import decimate, fir_filter, pnorm, pulse_shape, symbol_sync

    sig_dec = decimate(fir_filter(pulse_shape("rrc", 8, 1024, 0.01), sig_rx), 8, 2)
    sig_edc = edc(sig_dec, EDCConfig(L=800, D=17, Fs=64e9, Rs=32e9))
    d_ref = pnorm(symbol_sync(sig_edc, symb_ref, 2))
    n_sym = d_ref.shape[0]
    y = mimo_adapt_equalizer(
        pnorm(sig_edc),
        MIMOEqualizerConfig(nTaps=15, SpS=2, mu=(2e-3, 2e-3), alg=("nlms", "dd-lms"),
                            L=(n_train, n_sym - n_train), M=64, numIter=2, backend="pallas"),
        symb_ref=d_ref)
    y = cpr(y, CPRConfig(alg="bps-pallas", M=64, N=50, B=64, Ts=1 / 32e9))
    return pnorm(y[disc:-100]), d_ref[disc:-100]


def _nlc_correct(symb_rx, symb_hat, p_dbm, n_grid=10):
    """examples/perturbation_nlc.py's compensation: perturbation_nlin (AMR,
    matrixOrder 50, coeffTol -30 dB) on ``symb_hat``, subtracted with the
    EVM-best of a 10 x 10 amplitude / phase grid."""
    from opticommpy_torch.models.perturbation import PerturbationConfig, perturbation_nlin
    from opticommpy_torch.ops import pnorm

    cfg = PerturbationConfig(D=17.0, alpha=0.2, lspan=50.0, length=800.0, gamma=1.3, Rs=32e9,
                             mode="AMR", coeffTol=-30.0, matrixOrder=50, Pin=p_dbm)
    nlin = perturbation_nlin(symb_hat, cfg)
    p_peak = 0.5 * 10 ** (p_dbm / 10) * 1e-3
    delta = pnorm(np.sqrt(p_peak) * pnorm(symb_hat) + nlin) - pnorm(symb_hat)
    dev = symb_rx.device
    amps = torch.linspace(0.1, 4.1, n_grid, device=dev)
    phases = torch.arange(n_grid, device=dev, dtype=torch.float32) * (2 * np.pi / n_grid)
    scale = (amps[:, None] * torch.exp(1j * phases[None, :])).reshape(-1)
    cand = symb_rx[None] - scale[:, None, None] * delta[None]
    cand = cand / torch.sqrt(torch.mean(cand.abs() ** 2, dim=(1, 2), keepdim=True))
    evm = torch.mean((cand - pnorm(symb_hat)[None]).abs() ** 2, dim=(1, 2))
    return cand[torch.argmin(evm)]


def run_pert_path_m(dev, n_symbols=98_304):
    """Path M, the perturbation-NLC link (examples/perturbation_nlc.py with
    98,304 64-QAM symbols per polarization) on the JAX package's seed-7
    symbols: five launch powers as ten columns of one manakov_ssf call (16 x
    50 km, hz 0.5 km, ideal gain), then per power the linear receiver (K2 3
    launches, K1 1) and three arms: EDC, NLC on the ML hard decisions and NLC
    on the true symbols. Counters reset just before and read just after."""
    from opticommpy_torch.comm.metrics import fast_ber_calc
    from opticommpy_torch.comm.modulation import detector, norm_const
    from opticommpy_torch.models import SSFMConfig, manakov_ssf
    from opticommpy_torch.models.tx import set_power_for_par_ssfm

    smi = _smi()
    cfg_tx = pert_tx_config(n_symbols)
    cfg_ch = SSFMConfig(Ltotal=800, Lspan=50, hz=0.5, alpha=0.2, D=17, gamma=1.3, Fs=cfg_tx.Fs,
                        amp="ideal", nlprMethod=False, trapIters=1, fusedLinear=True)
    const = torch.as_tensor(norm_const(64, "qam"), device=dev)
    _reset_counts()
    sig_tx, symb_ref = pert_tx_from_jax_symbols(dev, cfg_tx)
    sig_batch = set_power_for_par_ssfm(torch.cat([sig_tx] * len(PERT_POWERS), dim=1),
                                       PERT_POWERS)
    sig_rx_all, ssfm_s = _wall(lambda: manakov_ssf(sig_batch, cfg_ch))
    scores, times = {}, {}
    for i, p_dbm in enumerate(PERT_POWERS):
        (y, d), times[p_dbm] = _wall(lambda i=i: _pert_rx(sig_rx_all[:, 2 * i:2 * i + 2],
                                                          symb_ref))
        symb_hat = torch.stack([detector(y[:, k], 0.5, const, rule="ML")[0] for k in range(2)],
                               dim=1)
        arms = {"edc": y}
        (arms["nlc"], nlc_s) = _wall(lambda: _nlc_correct(y, symb_hat, p_dbm))
        arms["nlc_ideal"] = _nlc_correct(y, d, p_dbm)
        times[p_dbm] = (times[p_dbm], nlc_s)
        scores[p_dbm] = {}
        for arm, sig in arms.items():
            ber, _, snr = fast_ber_calc(sig, d, 64, "qam")
            scores[p_dbm][arm] = dict(ber=ber.cpu().numpy(), snr=snr.cpu().numpy())
    torch.cuda.synchronize()
    counts = _counts()
    print(f"path M launches: {counts}")
    _check(counts == _expect(bps=len(PERT_POWERS), unwrap=len(PERT_POWERS),
                             mimo_eq=3 * len(PERT_POWERS)),
           f"path M launched {counts}, expected K1 and K15 x {len(PERT_POWERS)} and K2 x "
           f"{3 * len(PERT_POWERS)}")
    failures = []
    for p_dbm in PERT_POWERS:
        # where the JAX run's linear receiver lost the signal (4 dBm), a mean SNR
        # of the wreck is not a number to meet within 0.05 dB: the decision-
        # directed arms must lose it too, and BER is gated as everywhere
        lost = min(JAX_PERT[p_dbm]["edc"]["ber"]) > PERT_LOST_BER
        for arm in PERT_ARMS:
            got, ref = scores[p_dbm][arm], JAX_PERT[p_dbm][arm]
            snr, ref_snr = float(np.mean(got["snr"])), float(np.mean(ref["snr"]))
            gate = ("not gated: the JAX receiver lost the signal" if lost
                    else f"tolerance {SAME_SYMB_SNR_DB:g}")
            print(f"path M {p_dbm:+.1f} dBm {arm}: BER {got['ber']} (JAX {ref['ber']}), mean "
                  f"SNR {snr:.4f} dB (JAX {ref_snr:.4f}, {gate})")
            if not lost and not abs(snr - ref_snr) <= SAME_SYMB_SNR_DB:
                failures.append(f"{p_dbm} dBm {arm}: mean SNR {snr} dB, JAX {ref_snr}")
            if lost and arm != "nlc_ideal" and not min(got["ber"]) > PERT_LOST_BER:
                failures.append(f"{p_dbm} dBm {arm}: BER {got['ber']}, but the JAX receiver "
                                f"lost the signal (BER {ref['ber']})")
            for p in range(2):
                if not got["ber"][p] <= 2 * ref["ber"][p] + 1e-4:
                    failures.append(f"{p_dbm} dBm {arm} pol {p}: BER {got['ber'][p]} above "
                                    f"2 x JAX {ref['ber'][p]} + 1e-4")
    n_samples = sig_batch.shape[0] * len(PERT_POWERS)
    print(f"path M manakov_ssf (1,600 steps, {sig_batch.shape[0]} x {sig_batch.shape[1]} "
          f"samples): first call {ssfm_s:.3f} s, {n_samples / ssfm_s:.4e} samples/s ({smi})")
    print("path M per power: receiver s, NLC (hard decisions) s: " + ", ".join(
        f"{p:+.1f} dBm {t[0]:.3f} / {t[1]:.3f}" for p, t in times.items()) + f" ({smi})")
    _check(not failures, "path M failed:\n  " + "\n  ".join(failures))
    return dict(counts=counts, scores=scores, ssfm_s=ssfm_s)


# ---------------------------------------------------------------------------
# Phase N: the single calls of slice 6, CUDA against CPU tensors
# ---------------------------------------------------------------------------

PERT_REL = 1e-5  # phase N: NLIN waveforms on CUDA vs CPU, relative to the peak


def phase_slice6_n(dev, n_sym=2**16, seed=13):
    """Phase N: calc_nlin_perturbation ('fft', 'chunk') and its AMR form at
    2**16 symbols and matrixOrder 25; modulate_ofdm / demodulate_ofdm at Nfft
    256, CP 32, a pilot every 16th carrier, on ~2**20 samples; each on CUDA
    against the same call on CPU tensors. A save_state / load_state round trip
    on the card and one StageTimer stage."""
    from opticommpy_torch.comm import ofdm
    from opticommpy_torch.comm.modulation import norm_const
    from opticommpy_torch.models import LinearFiberConfig, linear_fiber_channel
    from opticommpy_torch.models import perturbation as pert
    from opticommpy_torch.utils.checkpoint import load_state, save_state
    from opticommpy_torch.utils.profiling import StageTimer

    smi = _smi()
    rng = np.random.default_rng(seed)
    c16 = norm_const(16, "qam")
    x = torch.as_tensor(c16[rng.integers(0, 16, n_sym)])
    y = torch.as_tensor(c16[rng.integers(0, 16, n_sym)])
    _, cf, cx, cs = pert.calc_pert_coeff_matrix(pert.PerturbationConfig(matrixOrder=25))
    for method in ("fft", "chunk"):
        _cuda_vs_cpu(f"calc_nlin_perturbation {method}", lambda a, b, m=method:
                     pert.calc_nlin_perturbation(cf, cx, cs, a, b, method=m), (x, y), PERT_REL,
                     dev, phase="N")
    kept = []

    def amr(a, b):
        out = pert.calc_nlin_perturbation_simplified(cf, cx, cs, a, b, -30.0)
        kept.append(out[4:])
        return out[:4]

    _cuda_vs_cpu("calc_nlin_perturbation_simplified (-30 dB)", amr, (x, y), PERT_REL, dev,
                 phase="N")
    print(f"phase N AMR kept {kept[0][0]} coefficients ({kept[0][1]}% fewer) on both")
    _check(kept[0] == kept[1], f"phase N AMR: kept {kept}")
    x_g, y_g = x.to(dev), y.to(dev)
    ms = {m: _cuda_ms(lambda m=m: pert.calc_nlin_perturbation(cf, cx, cs, x_g, y_g, method=m), 3)
          for m in ("fft", "chunk")}
    ms["amr"] = _cuda_ms(lambda: pert.calc_nlin_perturbation_simplified(cf, cx, cs, x_g, y_g,
                                                                        -30.0), 3)
    print(f"phase N NLIN at 2**16 symbols, matrixOrder 25, warm ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in ms.items()) + f" ({smi})")

    cfg = ofdm.OFDMConfig(Nfft=256, G=32, SpS=1, pilotCarriers=tuple(range(0, 256, 16)))
    n_frames = -(-2**20 // (cfg.Nfft + cfg.G))
    symb = torch.as_tensor(c16[rng.integers(0, 16, n_frames * 240)])
    sig = _cuda_vs_cpu("modulate_ofdm", lambda a: ofdm.modulate_ofdm(a, cfg), (symb,), 1e-5,
                       dev, phase="N")
    rx = linear_fiber_channel(sig.cpu(), LinearFiberConfig(L=40, alpha=0.0, D=17, Fs=10e9))
    out = _cuda_vs_cpu("demodulate_ofdm (channel estimate)", lambda a: ofdm.demodulate_ofdm(
        a, cfg, return_channel=True), (rx,), 1e-5, dev, phase="N")
    err = float((out[0] - symb.to(dev)).abs().max())
    print(f"phase N OFDM over 40 km, {sig.shape[0]} samples: max |symbol error| {err:.3e}")
    _check(err < 0.1, f"phase N OFDM: symbols off by {err}")
    ms_mod = _cuda_ms(lambda: ofdm.modulate_ofdm(symb.to(dev), cfg), 3)
    rx_g = rx.to(dev)
    ms_dem = _cuda_ms(lambda: ofdm.demodulate_ofdm(rx_g, cfg, return_channel=True), 3)
    print(f"phase N OFDM warm ms: modulate {ms_mod:.3f}, demodulate {ms_dem:.3f} ({smi})")

    state = {"field": sig, "taps": (x_g[:15], y_g[:15]), "n": torch.tensor(7, device=dev)}
    path = save_state(os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                                   "phase_n_state.npz"), state)
    back = load_state(path, like=state)
    same = all(torch.equal(a, b) and a.is_cuda for a, b in (
        (back["field"], sig), (back["taps"][0], x_g[:15]), (back["taps"][1], y_g[:15]),
        (back["n"], state["n"])))
    print(f"phase N save_state / load_state on the card: equal and on the card {same}")
    _check(same, "phase N checkpoint round trip")
    timer = StageTimer()
    with timer("nlin fft"):
        timer.sync(pert.calc_nlin_perturbation(cf, cx, cs, x_g, y_g))
    print(f"phase N StageTimer:\n{timer.table()}")
    _check(timer.times["nlin fft"] > 0, "phase N StageTimer recorded nothing")
    return ms


PP_REL = 1e-6  # phase O: manakov_ssf_pp on one stage against manakov_ssf, relative
SP_REL = 5e-4  # phase O: manakov_ssf_sp, default halo, against manakov_ssf (tests/test_parallel.py:176)
EDC_STEP_REL = 5e-2  # phase O: sharded_edc + matched filter against edc + fir_filter, interior


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def phase_parallel_o(dev, sig_tx, cfg_ch, gen_state, llr, train_in, ffw_in, edc_cfg, pulse,
                     sig_ch=None):
    """Phase O: ``opticommpy_torch.parallel`` at world size 1 on NCCL (one
    card: every collective meets a group of one), each route against its
    unsharded call on the inputs the run already has: the main path's Tx
    field through ``manakov_ssf_dp`` (EDFAs, from the generator state
    ``gen_state`` the main path's SSFM started from: bit for bit with
    ``manakov_ssf``, and whether it is the main path's field ``sig_ch``
    printed), an adaptive span with the world group (K16's sums and phase
    maximum all-reduced, as the dp route runs them: bit for bit with the
    span's CUDA graphs), ``manakov_ssf_pp`` (one stage, M = 1) and ``manakov_ssf_sp`` (default
    halo) with ideal gain (PP_REL, SP_REL) and with EDFAs (output power
    0.8-1.6 x the input); ``sharded_edc`` (``edc_cfg``) and the matched
    filter ``pulse`` by ``sharded_fir`` on the dp output (EDC_STEP_REL on
    the interior); the serving decoder (DVB-S2 R4/5, bf16 NMSA-20, early
    exit) on ``llr``, the trainer ``train_in`` = (signals, references,
    config) and feedforward clock recovery on ``ffw_in`` (the per-signal
    (signal, config) arguments) split over the ``data`` dim, each bit for
    bit with the unsharded call's kernel launches; then
    ``dryrun_multichip(1)``. Prints each stage's host-clock time and the
    NCCL start-up beside the card's name and power limit; returns them with
    the launches counted on the split routes."""
    from dataclasses import replace

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from opticommpy_torch.comm import fec_qc
    from opticommpy_torch.dsp import edc, mimo_adapt_equalizer_batch
    from opticommpy_torch.dsp.clock_recovery import ffw_clock_recovery
    from opticommpy_torch.models import manakov_ssf
    from opticommpy_torch.ops import fir_filter
    from opticommpy_torch.parallel import (P, default_sp_halo, init_distributed, make_mesh,
                                           manakov_ssf_dp, manakov_ssf_pp, manakov_ssf_sp,
                                           sharded_edc, sharded_fir)
    from opticommpy_torch.parallel.dryrun import dryrun_multichip
    from opticommpy_torch.parallel.sharded import _data_parallel

    smi = _smi()
    secs = {}
    t0 = time.perf_counter()
    rank_world = init_distributed(device=dev)
    x = torch.arange(8, dtype=torch.float32, device=dev)
    dist.all_reduce(x)
    total = float(x.sum())
    secs["NCCL start-up and first all-reduce"] = time.perf_counter() - t0
    print(f"phase O: group {rank_world} on {dist.get_backend()}, all-reduce sum {total}")
    _check(rank_world == (0, 1) and dist.get_backend() == "nccl" and total == 28.0,
           f"phase O: group {rank_world} on {dist.get_backend()}, sum {total}")
    mesh = make_mesh(1, 1, device_type=dev.type)
    stages = DeviceMesh(dev.type, torch.arange(1), mesh_dim_names=("stage",))
    _check(mesh.device_type == "cuda", f"phase O: mesh on {mesh.device_type}")

    def gen():
        g = torch.Generator(device=dev)
        g.set_state(gen_state)
        return g

    ref, _ = _wall(lambda: manakov_ssf(sig_tx, cfg_ch, gen()))
    out_dp, secs["dp SSFM (EDFA)"] = _wall(lambda: manakov_ssf_dp(sig_tx, cfg_ch, gen(), mesh))
    same = bool(torch.equal(out_dp, ref))
    print(f"phase O dp SSFM {tuple(sig_tx.shape)}, EDFA: bit-identical to manakov_ssf {same}")
    if sig_ch is not None:
        print(f"phase O dp SSFM bit-identical to the main path's field: "
              f"{bool(torch.equal(out_dp, sig_ch))}")
    _check(same and out_dp.is_cuda, "phase O: manakov_ssf_dp differs from manakov_ssf")
    # an adaptive span with a process group (the world of one: a mesh dim of
    # size 1 has none), the dp route's: K16's sums and phase maximum
    # all-reduced, the step rule a launch of its own after it, in the eager
    # loop, against the CUDA graphs' route
    from opticommpy_torch.kernels import ssfm_pass
    from opticommpy_torch.models import channels as tch

    cfg_a = replace(cfg_ch, nlprMethod=True, trapIters=0, maxNlinPhaseRot=2e-2)
    e_a = tch._to_pol_stacked(sig_tx, cfg_a)
    lin_a = tch._lin_arg(e_a.shape[-1], cfg_a, e_a.dtype, e_a.device)
    ref_a = tch._manakov_span(e_a, lin_a, cfg_a.Lspan, cfg_a)
    k16_before = ssfm_pass.launches
    out_a, secs["adaptive span with a group"] = _wall(
        lambda: tch._manakov_span(e_a, lin_a, cfg_a.Lspan, cfg_a, group=dist.group.WORLD))
    k16 = ssfm_pass.launches - k16_before
    same_a = bool(torch.equal(out_a, ref_a))
    print(f"phase O adaptive span with a group: bit-identical to the span without one "
          f"{same_a}, K16 launches {k16}")
    _check(same_a and k16 > 0, "phase O: the adaptive span with a group differs from the span "
           "without one or ran no K16 kernel")

    cfg_i = replace(cfg_ch, amp="ideal")
    ref_i, _ = _wall(lambda: manakov_ssf(sig_tx, cfg_i))
    out_pp, secs["pp SSFM (1 stage, M 1)"] = _wall(
        lambda: manakov_ssf_pp(sig_tx, cfg_i, None, stages, n_microbatches=1))
    err_pp = _rel(out_pp, ref_i)
    halo = default_sp_halo(cfg_i)
    out_sp, secs["sp SSFM (default halo)"] = _wall(lambda: manakov_ssf_sp(sig_tx, cfg_i,
                                                                          mesh=mesh))
    err_sp = _rel(out_sp, ref_i)
    print(f"phase O pp vs manakov_ssf (ideal gain): relative error {err_pp:.3e} (< {PP_REL}), "
          f"bit-identical {bool(torch.equal(out_pp, ref_i))}; sp (halo {halo}): {err_sp:.3e} "
          f"(< {SP_REL})")
    _check(err_pp <= PP_REL, f"phase O: pp off by {err_pp}")
    _check(err_sp < SP_REL, f"phase O: sp off by {err_sp}")
    del ref_i, out_pp, out_sp
    p_in = float(torch.mean(torch.abs(sig_tx) ** 2))
    for name, run in (("pp", lambda: manakov_ssf_pp(sig_tx, cfg_ch, gen(), stages,
                                                     n_microbatches=1)),
                      ("sp", lambda: manakov_ssf_sp(sig_tx, cfg_ch, gen(), mesh=mesh))):
        out, secs[f"{name} SSFM (EDFA)"] = _wall(run)
        ratio = float(torch.mean(torch.abs(out) ** 2)) / p_in
        print(f"phase O {name} SSFM with EDFAs: output / input power {ratio:.4f} (0.8-1.6)")
        _check(0.8 < ratio < 1.6 and bool(torch.isfinite(out).all()),
               f"phase O: {name} EDFA power ratio {ratio}")
        del out

    y_s, secs["sharded_edc + matched filter"] = _wall(lambda: sharded_fir(
        sharded_edc(out_dp, edc_cfg, mesh, mode_axis="data"), pulse, mesh, mode_axis="data"))
    y_r = fir_filter(pulse, edc(out_dp, edc_cfg))
    err_rx = _rel(y_s[600:-600], y_r[600:-600])
    print(f"phase O sharded_edc + matched filter vs edc + fir_filter: {err_rx:.3e} on "
          f"the interior (< {EDC_STEP_REL})")
    _check(err_rx < EDC_STEP_REL, f"phase O: receive step off by {err_rx}")
    del y_s, y_r, out_dp, ref

    split = {}
    dec = fec_qc.make_qc_decoder(64800, "4/5", 20, "NMSA", "bf16", True)
    train_sig, train_ref, eq_cfg = train_in
    ffw_sig = torch.stack([args[0] for args in ffw_in])
    ffw_cfg = ffw_in[0][1]

    def train(s, r):
        return mimo_adapt_equalizer_batch(s, eq_cfg, symb_ref=r, return_results=True)

    def ffw(s):
        return torch.stack([ffw_clock_recovery(x, ffw_cfg) for x in s])

    routes = (
        ("dp decode", dec, (llr,), (P(None, "data"),), (P(None, "data"), P("data"), P("data"))),
        ("dp trainer", train, (train_sig, train_ref), (P("data"), P("data")),
         (P("data"), P("data"), P("data"))),
        ("dp ffw clock recovery", ffw, (ffw_sig,), (P("data"),), P("data")))
    for name, fn, args, in_specs, out_specs in routes:
        _reset_counts()
        want, _ = _wall(lambda: fn(*args))
        c_ref = _counts()
        _reset_counts()
        got, secs[name] = _wall(lambda: _data_parallel(fn, mesh, in_specs, out_specs)(*args))
        split[name] = _counts()
        want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
        same = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
        print(f"phase O {name}: bit-identical to the unsharded call {same}; launches "
              f"{_nonzero(split[name])} (unsharded {_nonzero(c_ref)})")
        _check(same, f"phase O: {name} differs from the unsharded call")
        _check(split[name] == c_ref, f"phase O: {name} launched {split[name]}, unsharded {c_ref}")
    _check(split["dp decode"] == _expect(qc_mega=1), f"phase O dp decode: {split['dp decode']}")
    _check(split["dp trainer"] == _expect(mimo_eq_batch=3),
           f"phase O dp trainer: {split['dp trainer']}")

    _, secs["dryrun_multichip(1)"] = _wall(lambda: dryrun_multichip(1, device=dev))
    dist.destroy_process_group()
    for name, sec in secs.items():
        print(f"phase O {name}: {sec:.4f} s (host clock; {smi})")
    return dict(secs=secs, qc_mega=split["dp decode"]["qc_mega"],
                mimo_eq_batch=split["dp trainer"]["mimo_eq_batch"])


def main():
    dev = phase_device()
    phase_build()
    from opticommpy_torch.comm.modulation import norm_const
    from opticommpy_torch.kernels import bps, mimo_eq
    from opticommpy_torch.kernels import unwrap as tunwrap

    const = norm_const(16, "qam")
    phase_s = {}
    t0 = time.perf_counter()
    report = phase_kernels_vs_plain(dev, const)
    report.update(phase_batch_kernels_vs_plain(dev, const))
    phase_s["K1-K5 vs plain"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report.update(phase_clock_pll_kernels(dev, const))
    phase_s["K6, K7 vs plain"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    bps.launches = 0
    mimo_eq.launches = 0
    tunwrap.launches = 0
    res, times = run_main_path(dev)
    launches = {"bps": bps.launches, "mimo_eq": mimo_eq.launches, "unwrap": tunwrap.launches}
    print(f"main path launches: {launches}")

    n_samples = res["sig_tx"].shape[0]
    n_sym = res["d_ref"].shape[0]
    print(f"Tx: {times['tx_s']:.3f} s for {tuple(res['sig_tx'].shape)} samples x pols")
    print(f"SSFM: {times['ssfm_s']:.3f} s, {n_samples / times['ssfm_s']:.4e} samples/s "
          "(first call, 500 steps)")
    print(f"DSP chain: {times['dsp_s']:.3f} s, {n_sym / times['dsp_s'] / 1e6:.4f} Msym/s "
          "(first call)")
    print(f"BER {res['ber']}, GMI {res['gmi']} bit, EVM {res['evm']}, SNR {res['snr']} dB")

    # checks
    _check(launches["bps"] >= 1, "the main path never launched the BPS kernel")
    _check(launches["unwrap"] >= 1, "the main path never launched the unwrap kernel")
    _check(launches["mimo_eq"] >= 3, "the main path launched the equalizer kernel "
           f"{launches['mimo_eq']} times, expected one per training pass (3)")
    y = res["y"]
    _check(tuple(y.shape) == (n_sym, 2) and y.is_cuda, f"unexpected output {tuple(y.shape)}")
    _check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(res["phases"]).all()),
           "non-finite chain output")
    _check(np.all(np.isfinite(res["ber"])) and np.all(np.isfinite(res["gmi"])),
           "non-finite metrics")
    for p in range(2):
        _check(res["ber"][p] <= 2 * JAX_BER[p] + 1e-4,
               f"BER {res['ber'][p]} above 2 x JAX {JAX_BER[p]} + 1e-4 (pol {p})")
        _check(res["gmi"][p] >= JAX_GMI[p] - 0.05,
               f"GMI {res['gmi'][p]} below JAX {JAX_GMI[p]} - 0.05 (pol {p})")

    # the same chain on CPU tensors (the kernels' plain versions), small input
    from opticommpy_torch.models import manakov_ssf
    from opticommpy_torch.pipelines import CoherentDSPConfig, coherent_dsp_chain

    small = CoherentDSPConfig(SpS_in=16, L=250, nTrain=2000, mu=(5e-3, 2e-3),
                              eqBackend="pallas", cprBackend="pallas")
    sig_s = res["sig_rx"][: 4096 * 16]
    ref_s = res["d_ref"][:4096]
    y_gpu, _ = coherent_dsp_chain(sig_s, ref_s, small)
    y_cpu, _ = coherent_dsp_chain(sig_s.cpu(), ref_s.cpu(), small)
    d = (y_gpu.cpu() - y_cpu).abs()
    far = float((d > 1e-3).float().mean())
    print(f"chain CUDA vs CPU plain (4096 symbols): max |diff| {float(d.max()):.3e}, "
          f"share > 1e-3: {far:.2e}")
    _check(far <= 1e-3 and float(d.max()) < 0.05, "chain on CUDA disagrees with CPU")

    # the whole main path again from the same seed: which stage is reproducible
    res2, _ = run_main_path(dev)
    for key in ("sig_tx", "sig_ch", "sig_rx", "d_ref", "y"):
        print(f"main path from the same seed twice: {key} bit-identical "
              f"{bool(torch.equal(res[key], res2[key]))} (max |diff| "
              f"{float((res[key] - res2[key]).abs().max()):.3e})")

    # warm re-runs for the phase times
    _, ssfm_warm = _wall(lambda: manakov_ssf(res["sig_tx"], res["cfg_ch"], res["gen"]))
    _, dsp_warm = _wall(lambda: coherent_dsp_chain(res["sig_rx"], res["d_ref"], res["cfg"]))
    print(f"SSFM warm: {ssfm_warm:.3f} s, {n_samples / ssfm_warm:.4e} samples/s")
    print(f"DSP chain warm: {dsp_warm:.3f} s, {n_sym / dsp_warm / 1e6:.4f} Msym/s")

    phase_s["main path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    wdm = run_wdm_paths(dev, res)
    phase_s["WDM batch chains"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    psk_counts = run_psk_path(dev)
    phase_s["8-PSK path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_a = run_cr_path_a(dev, res)
    k6 = path_a["k6"]
    report["gardner"] = _with_cycles(_with_bound(
        dict(max_abs_err=max(k6["max_abs_err"], report.pop("gardner_short_err")), ms=k6["ms"],
             plain_ms=k6["plain_ms"]), *k6["cost"]), k6["n_in"], k6["sm_clock_mhz"])
    phase_s["path A"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sig_b, ref_b = wdm.pop("received")
    path_b = run_cr_path_b(dev, res, sig_b, ref_b)
    phase_s["path B"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_k = run_scan_phase_k(dev, res, sig_b, ref_b, dsp_warm)
    del sig_b, ref_b
    phase_s["phase K"] = time.perf_counter() - t0
    print(f"phase K: {phase_s['phase K']:.1f} s")
    t0 = time.perf_counter()
    path_c = run_serve_path_c(dev, res)
    phase_s["path C"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph, cw_e, llr_e = _path_e_llrs(dev)
    report.update(phase_ldpc_kernels(dev, llr_e))
    phase_s["K8-K10 vs plain"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report.update(phase_mega_lift_kernels(dev, llr_e))
    phase_s["K11, K12 vs plain"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_e = run_ldpc_path_e(dev, graph, cw_e, llr_e)
    phase_s["path E"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_f = run_ldpc_path_f(dev, graph, cw_e, llr_e)
    del graph, cw_e, llr_e
    phase_s["path F"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_d = run_coded_path_d(dev, res)
    phase_s["path D"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_g = run_lift_path_g(dev)
    phase_s["path G"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report.update(phase_imdd_kernels(dev))
    phase_s["K13, K14 vs plain"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_h = run_imdd_path_h(dev)
    phase_s["path H"] = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30  # path I resets the peak
    t0 = time.perf_counter()
    path_i = run_dbp_path_i(dev)
    phase_s["path I"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_single_pol(dev)
    phase_s["phase J"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_l = run_edfa_path_l(dev)
    phase_s["path L"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_m = run_pert_path_m(dev)
    phase_s["path M"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_slice6_n(dev)
    phase_s["phase N"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    from opticommpy_torch.dsp import EDCConfig
    from opticommpy_torch.ops import pulse_shape

    path_o = phase_parallel_o(
        dev, res["sig_tx"], res["cfg_ch"], res["gen_state_ssfm"], _path_e_llrs(dev)[2],
        path_c.pop("train_in"),
        path_b.pop("ffw_in"), EDCConfig(L=250, D=16, Fs=res["cfg_ch"].Fs, Rs=32e9),
        pulse_shape("rrc", 16, 1024, 0.01).astype(np.float32), sig_ch=res["sig_ch"])
    phase_s["phase O"] = time.perf_counter() - t0
    for name, sec in phase_s.items():
        print(f"phase time: {name} {sec:.1f} s")
    peak_gib = max(peak_gib, torch.cuda.max_memory_allocated() / 2**30)
    print(f"peak device memory: {peak_gib:.2f} GiB")
    failures = path_b["failures"] + path_c["failures"] + path_h["failures"]
    _check(not failures, "bounds against the JAX package failed:\n  " + "\n  ".join(failures))

    kernels = [
        dict(name="bps", route="cuda", source="opticommpy_torch/csrc/bps.cu",
             replaces="opticommpy_tpu/kernels/bps_pallas.py:165",
             launches=launches["bps"], path_i_launches=path_i["counts"]["bps"],
             path_l_launches=path_l["counts"]["bps"], path_m_launches=path_m["counts"]["bps"],
             path_k_launches={k: path_k[k]["counts"]["bps"] for k in ("chain", "batch")},
             **report["bps"]),
        dict(name="mimo_eq", route="cuda", source="opticommpy_torch/csrc/mimo_eq.cu",
             replaces="opticommpy_tpu/kernels/mimo_pallas.py:227",
             launches=launches["mimo_eq"], path_i_launches=path_i["counts"]["mimo_eq"],
             path_l_launches=path_l["counts"]["mimo_eq"],
             path_m_launches=path_m["counts"]["mimo_eq"],
             **report["mimo_eq"]),
        dict(name="mimo_eq_batch", route="cuda", source="opticommpy_torch/csrc/mimo_eq.cu",
             replaces="opticommpy_tpu/kernels/mimo_pallas.py:467",
             launches=wdm["da-rde/dd-lms"]["counts"]["mimo_eq_batch"],
             phase_o_launches=path_o["mimo_eq_batch"], **report["mimo_eq_batch"]),
        dict(name="rls_argmin", route="cuda", source="opticommpy_torch/csrc/rls.cu",
             replaces="opticommpy_tpu/kernels/rls_pallas.py:183",
             launches=psk_counts["rls"], **report["rls_argmin"]),
        dict(name="rls_batch", route="cuda", source="opticommpy_torch/csrc/rls.cu",
             replaces="opticommpy_tpu/kernels/rls_pallas.py:367",
             launches=wdm["rls/dd-rls"]["counts"]["rls_batch"], **report["rls_batch"]),
        dict(name="gardner", route="cuda", source="opticommpy_torch/csrc/gardner.cu",
             replaces="opticommpy_tpu/kernels/gardner_pallas.py:167",
             launches=path_a["counts"]["gardner"], **report["gardner"]),
        dict(name="ddpll", route="cuda", source="opticommpy_torch/csrc/ddpll.cu",
             replaces="opticommpy_tpu/kernels/ddpll_pallas.py:106",
             launches=path_c["pll_counts"]["ddpll"], **report["ddpll"]),
        dict(name="ldpc_check", route="cuda", source="opticommpy_torch/csrc/ldpc_check.cu",
             replaces="opticommpy_tpu/kernels/ldpc_pallas.py:83",
             launches=path_f["counts"]["ldpc_check"], **report["ldpc_check"]),
        dict(name="qc_check", route="cuda", source="opticommpy_torch/csrc/qc.cu",
             replaces="opticommpy_tpu/kernels/qc_pallas.py:274",
             launches=path_e["counts"]["qc_check"], **report["qc_check"]),
        dict(name="qc_var", route="cuda", source="opticommpy_torch/csrc/qc.cu",
             replaces="opticommpy_tpu/kernels/qc_pallas.py:411",
             launches=path_e["counts"]["qc_var"], **report["qc_var"]),
        dict(name="qc_mega", route="cuda", source="opticommpy_torch/csrc/qc_mega.cu",
             replaces="opticommpy_tpu/kernels/qc_mega.py:443",
             launches=path_d["counts"]["qc_mega"], phase_o_launches=path_o["qc_mega"],
             **report["qc_mega"],
             bound_share=report["qc_mega"]["bound_ms"] / report["qc_mega"]["ms"]),
        dict(name="lift_iter", route="cuda", source="opticommpy_torch/csrc/lift.cu",
             replaces="opticommpy_tpu/kernels/lift_pallas.py:182",
             launches=path_g["counts"]["lift_iter"], **report["lift_iter"],
             bound_share=report["lift_iter"]["bound_ms"] / report["lift_iter"]["ms"],
             path_g_warm_ms={k: path_g[k]["ms"] for k in ("f32", "80211n")} | dict(
                 bf16=path_g["ms"])),
        dict(name="dfe", route="cuda", source="opticommpy_torch/csrc/dfe.cu",
             replaces="opticommpy_tpu/kernels/dfe_pallas.py:160",
             launches=path_h["dfe"]["counts"]["dfe"], **report["dfe"],
             path_h={eq: path_h[eq]["k13"] for eq in ("dfe", "ffe")}),
        dict(name="volterra", route="cuda", source="opticommpy_torch/csrc/volterra.cu",
             replaces="opticommpy_tpu/kernels/volterra_pallas.py:115",
             launches=path_h["vol_counts"]["volterra"], **report["volterra"],
             path_h=path_h["k14"]),
        dict(name="unwrap", route="cuda", source="opticommpy_torch/csrc/unwrap.cu",
             replaces="no Pallas counterpart (jnp.unwrap)", launches=launches["unwrap"],
             **report["unwrap"]),
        dict(name="ssfm_pass", route="cuda", source="opticommpy_torch/csrc/ssfm_pass.cu",
             replaces="no Pallas counterpart (the adaptive Manakov step's elementwise XLA ops)",
             path_l_launches=path_l["k16_launches"], path_l_steps=path_l["ssfm_steps"],
             path_l_passes=path_l["ssfm_passes"], **report["ssfm_pass"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
