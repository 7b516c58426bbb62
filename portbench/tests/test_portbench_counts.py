"""The operation and byte counts behind the rooflines, against hand-worked
values."""

from harness import core


def test_ssfm_count_north_star():
    ssfm = core.counts("ssfm")
    fib = core.config("wdm11_16qam_5x50km")["fiber"]
    assert ssfm.link_steps(fib) == 500  # 5 spans x 50 km / 0.5 km
    flops, nbytes = ssfm.manakov(2 ** 20, 500)
    # 500 steps x 2 polarizations x (forward + inverse) x 5 N log2 N
    assert flops == 500 * 2 * 2 * 5 * 2 ** 20 * 20 == 2.097152e11
    assert nbytes == 2 * 2 ** 20 * 2 * 8  # complex64 field in and out once
    bound, by = core.counts("peaks").bound_s(flops, nbytes)
    assert by == "operations" and abs(bound - 3.13008e-3) < 1e-7


def test_ldpc_count_dvbs2_r45():
    c = core.reference("dvbs2_r45_coded").code()
    edges = len(c["rows"])
    assert (c["m"], c["dc"], edges) == (12960, 18, 12960 * 18 - 1)  # check 0 has one parity edge
    ops, nbytes = core.counts("ldpc").decode(edges, 64800, [10, 12])
    assert ops == 4 * 233279 * 22 == 20528552
    assert nbytes == 2 * 64800 * 9 + 2
    bound, by = core.counts("peaks").bound_s(ops, nbytes)
    assert by == "bytes" and abs(bound - nbytes / 3.35e12) < 1e-15


def test_readers_never_read_from_nothing():
    from harness import core

    tr = {"range_calls": {}, "range_dev_s": {}, "busy_s": 0.0, "units": 2, "unit_wall_s": 0.1,
          "kernel_s": {}, "spans": {}}
    for metric in ("decode_ms.decode", "device_idle.rx", "eq_kernel_ms.rx", "ssfm_ms.link",
                   "ssfm_roofline.link", "decode_roofline.decode"):
        assert core.reader(metric)(None, None, tr) is None, metric


def test_idle_share_against_the_unprofiled_window():
    from harness import core

    # 0.06 s busy a unit under the profiler, 0.1 s a unit without it: 40% idle
    tr = {"busy_s": 0.12, "units": 2, "unit_wall_s": 0.1}
    assert abs(core.reader("device_idle.rx")(None, None, tr) - 40.0) < 1e-9
