"""The trace reduction on made-up timelines: the union of device
intervals, idle gaps by host work, and the kernel readers."""

import pytest

from portbench import harness
from portbench.counts.attention import k1_bound_s, k1b_bound_s
from portbench.timeline import WINDOW, Timeline, covered, gaps, union


def reader(family):
    return harness.load_module(harness.HERE / "metrics" / f"{family}.py",
                               f"t_{family}").read


def test_union_merges_overlaps_and_clips():
    iv = [(5, 10), (0, 3), (2, 4), (8, 12), (20, 30)]
    assert union(iv, 0, 25) == [(0, 4), (5, 12), (20, 25)]
    assert covered(iv, 0, 25) == 16
    assert gaps(iv, 0, 25) == [(4, 5), (12, 20)]
    assert covered([], 0, 10) == 0 and gaps([], 0, 10) == [(0, 10)]


def test_idle_share_counts_overlapping_kernels_once():
    # Two streams overlap on [10, 20): a sum of kernel times would read
    # 40 ns busy of 50, the union reads 30.
    tl = Timeline(device=[(0, 20, "a"), (10, 30, "b")], window=(0, 50))
    assert tl.busy_s() == pytest.approx(30e-9)
    assert reader("idle_share")(tl, {}) == pytest.approx(40.0)
    assert reader("idle_share")(Timeline(window=(0, 5)), {}) is None


def test_idle_gaps_name_the_host_work():
    tl = Timeline(device=[(0, 10, "k"), (40, 50, "k")],
                  spans=[(0, 100, WINDOW), (5, 45, "render")],
                  ops=[(12, 38, "aten::sort"), (60, 90, "aten::copy_")],
                  window=(0, 100))
    got = dict(tl.idle_gaps())
    assert got == {"render: aten::sort": pytest.approx(30e-9),
                   "host: aten::copy_": pytest.approx(50e-9)}
    assert tl.device_ops() == [["k", pytest.approx(20e-9)]]


def test_attention_roofline_by_head_dim():
    sites = [(16, 4096, 32), (16, 1024, 64), (16, 256, 64)]
    fwd = "void mha_fwd_wgmma_kernel<{}, 4>(CUtensorMap)"
    dq = "void mha_bwd_dq_wgmma_kernel<{}, 2>(CUtensorMap)"
    dkv = "void mha_bwd_dkv_wgmma_kernel<{}, 2, 64>(CUtensorMap)"
    dev, t = [], 0
    for name, d in ((fwd, 32), (fwd, 64), (fwd, 64), (dq, 32), (dkv, 32),
                    (dq, 64), (dkv, 64), (dq, 64), (dkv, 64)):
        dev.append((t, t + 1000, name.format(d)))
        t += 2000
    tl = Timeline(device=dev, window=(0, t))
    r = {"k1_calls": sites, "k1b_calls": sites, "units": 1}
    need = sum(k1_bound_s(b, s, s, d) + k1b_bound_s(b, s, s, d)
               for b, s, d in sites)
    assert reader("attn_roofline")(tl, r) == pytest.approx(
        100 * need / 9e-6)
    # Launches that are not whole units of the cell's calls: not read.
    tl.device = dev[1:]
    assert reader("attn_roofline")(tl, r) is None


def test_composite_and_span_readers():
    tl = Timeline(device=[(0, 2_000_000, "composite_fwd_kernel<4, 2>"),
                          (3_000_000, 7_000_000, "composite_bwd_kernel<2>"),
                          (8_000_000, 9_000_000, "other")],
                  spans=[(0, 10_000_000, WINDOW),
                         (0, 3_000_000, "optimizer"),
                         (5_000_000, 6_000_000, "optimizer")],
                  window=(0, 10_000_000))
    r = {"units": 2, "spans": {"orbit": [1.0, 2.0], "forward": [0.1]},
         "flops_per_unit": 989e12 * 0.01}
    assert reader("composite_ms")(tl, r) == pytest.approx(3.0)
    assert reader("optimizer_ms")(tl, r) == pytest.approx(2.0)
    assert reader("lpips_ms")(tl, r) is None
    assert reader("orbit_s")(tl, r) == pytest.approx(1.5)
    assert reader("forward_ms")(tl, r) == pytest.approx(100.0)
    assert reader("mfu")(tl, r) == pytest.approx(100 * 2 * 0.01 / 0.01)


def test_idle_gaps_read_host_work_on_every_thread():
    # Ops of two threads overlap without nesting: a gap is labelled by the
    # latest-started op still running at its midpoint.
    tl = Timeline(device=[(0, 20, "k"), (40, 52, "k"), (64, 70, "k")],
                  spans=[(0, 80, WINDOW), (0, 80, "loss_backward")],
                  ops=[(0, 50, "a"), (25, 62, "b"), (55, 75, "c")],
                  window=(0, 80))
    assert dict(tl.idle_gaps()) == {
        "loss_backward: b": pytest.approx(20e-9),
        "loss_backward: c": pytest.approx(12e-9),
        "loss_backward: python": pytest.approx(10e-9)}
