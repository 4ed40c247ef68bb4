"""The readers of the program's own ranges and counters on made-up
timelines: the backward ranges, the renderer's launches (on any thread)
and the compositors' roofline from the program's counters."""

import pytest

from portbench import harness
from portbench.counts.composite import composite_bound_s
from portbench.timeline import WINDOW, Timeline


def reader(family):
    return harness.load_module(harness.HERE / "metrics" / f"{family}.py",
                               f"t_{family}").read


@pytest.mark.parametrize("family,span", [
    ("render_bwd_ms", "render.backward"), ("lpips_bwd_ms", "lpips.backward"),
    ("lgm_bwd_ms", "lgm.backward"), ("render_ms", "render")])
def test_range_readers_read_ms_a_unit(family, span):
    tl = Timeline(spans=[(0, 10_000_000, WINDOW),
                         (1_000_000, 4_000_000, span),
                         (5_000_000, 6_000_000, span),
                         (6_000_000, 9_000_000, span + ".other")],
                  window=(0, 10_000_000))
    assert reader(family)(tl, {"units": 2}) == pytest.approx(2.0)
    assert reader(family)(Timeline(window=(0, 10)), {"units": 2}) is None


def test_render_launches_count_both_threads():
    # The forward's launches on the calling thread, the backward's on
    # autograd's (the caller waits in backward()), and launches outside
    # the renderer's ranges that are not counted.
    tl = Timeline(
        spans=[(0, 1000, WINDOW), (100, 300, "render"),
               (150, 200, "render.composite"), (500, 800, "render.backward"),
               (600, 700, "render.composite.backward"),
               (400, 900, "loss_backward")],
        ops=[(110, 120, "cudaLaunchKernel"), (160, 170, "cudaLaunchKernelExC"),
             (180, 190, "aten::sort"), (350, 360, "cudaLaunchKernel"),
             (510, 520, "cuLaunchKernel"), (650, 660, "cudaLaunchKernel"),
             (790, 850, "cuLaunchKernelEx"), (850, 860, "cudaLaunchKernel"),
             (1100, 1110, "cudaLaunchKernel")],
        window=(0, 1000))
    assert reader("render_launches")(tl, {"units": 2}) == 2.5
    assert reader("render_launches")(Timeline(window=(0, 10)),
                                      {"units": 1}) is None


@pytest.fixture
def counted(monkeypatch):
    """The program's counters as ``lgm_tpu_torch.trace.counters`` gives
    them, set by the test."""
    from lgm_tpu_torch import trace

    values = {}
    monkeypatch.setattr(trace, "counters", lambda: dict(values))
    return values


def test_composite_roofline_over_the_kernels_device_time(counted):
    fwd = "void (anonymous namespace)::composite_fwd_kernel<4, 2>(float)"
    bwd = "void (anonymous namespace)::composite_bwd_kernel<4>(float)"
    tl = Timeline(device=[(0, 100_000, fwd), (200_000, 300_000, fwd),
                          (400_000, 700_000, bwd), (800_000, 900_000, "x")],
                  window=(0, 1_000_000))
    counted.update({"composite_fwd.launches": 2,
                    "composite_fwd.pairs": 200_000_000,
                    "composite_fwd.bytes": 40_000_000,
                    "composite_bwd.launches": 1,
                    "composite_bwd.pairs": 100_000_000,
                    "composite_bwd.bytes": 300_000_000})
    need = (composite_bound_s(200_000_000, 40_000_000)
            + composite_bound_s(100_000_000, 300_000_000))
    got = reader("composite_roofline")(tl, {"units": 1})
    assert got == pytest.approx(100 * need / 500e-6)
    assert 0 < got < 100
    # The exp bounds the forward's pairs, the bytes the backward's.
    assert composite_bound_s(200_000_000, 40_000_000) == pytest.approx(
        200e6 / (16 * 132 * 1.98e9))
    assert composite_bound_s(100_000_000, 300_000_000) == pytest.approx(
        300e6 / 3.35e12)


@pytest.mark.parametrize("launches", [
    {"composite_fwd.launches": 1, "composite_bwd.launches": 0},
    {"composite_fwd.launches": 2, "composite_bwd.launches": 1},
    {}])
def test_composite_roofline_is_not_read_on_a_count_mismatch(counted,
                                                            launches):
    tl = Timeline(device=[(0, 100, "composite_fwd_kernel<4, 2>"),
                          (200, 300, "composite_fwd_kernel<4, 2>")],
                  window=(0, 1000))
    counted.update({"composite_fwd.pairs": 10, "composite_fwd.bytes": 10,
                    "composite_bwd.pairs": 0, "composite_bwd.bytes": 0,
                    **launches})
    assert reader("composite_roofline")(tl, {"units": 1}) is None


def test_composite_roofline_without_the_program_counters(monkeypatch):
    # A program without ``lgm_tpu_torch.trace`` (an older commit): no value.
    import sys

    import lgm_tpu_torch

    monkeypatch.delattr(lgm_tpu_torch, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "lgm_tpu_torch.trace", None)
    tl = Timeline(device=[(0, 100, "composite_fwd_kernel<4, 2>")],
                  window=(0, 1000))
    assert reader("composite_roofline")(tl, {"units": 1}) is None
