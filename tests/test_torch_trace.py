"""The program's own trace (``lgm_tpu_torch/trace.py``) on the CPU: the
ranges of a profiled nano train step and orbit, backward ranges that open
and close on autograd's thread, nothing built while no profiler runs, the
compositors' work counters against ``composite_work``, and LPIPS's graph
counters (on a stand-in graph that reruns the fold eagerly)."""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lgm_tpu_torch import infer, trace, train
from lgm_tpu_torch.config import get_config
from lgm_tpu_torch.data.synthetic import make_batch, sample_scene
from lgm_tpu_torch.ops.gsplat import flatsort as fs
from test_torch_lpips_fold import EagerGraph
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

PER_VIEW = ("render.project", "render.bin", "render.gather",
            "render.composite")
BACKWARD = ("lpips.backward", "render.backward", "lgm.backward")


def _ranges(prof):
    """(start, end, name) of every user range of a stopped profiler."""
    return [(ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
            for ev in prof.profiler.kineto_results.events()
            if ev.is_user_annotation()]


@pytest.fixture(scope="module")
def nano_step():
    """A nano state with LPIPS on (its seeded random weights) and one
    batch of 2 scenes x 4 views."""
    opt = get_config("nano").replace(lambda_lpips=1.0)
    state = train.create_state(opt, "cpu")
    batch = make_batch(np.random.default_rng(0), opt, n_gaussians=64,
                       device="cpu")
    data = {k: v for k, v in batch.items() if k != "scenes"}
    return opt, state, data, torch.rand(3, generator=torch.Generator()
                                        .manual_seed(1))


@pytest.fixture(autouse=True)
def fresh_counters():
    trace.reset()
    yield
    trace.reset()


def _markers(loss) -> list:
    """Names of the trace's marker nodes in ``loss``'s graph."""
    seen, todo, found = set(), [loss.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if type(fn).__name__ in ("_OpenBackward", "_CloseBackward"):
            found.append(type(fn).__name__)
        todo += [f for f, _ in fn.next_functions]
    return found


def test_profiled_train_step_has_every_range(nano_step):
    opt, state, data, bg = nano_step
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train.train_step(state, data, bg)
    ranges = _ranges(prof)
    n = Counter(name for _, _, name in ranges)
    views = opt.batch_size * opt.num_views
    for name in ("render",) + PER_VIEW:
        assert n[name] == (1 if name == "render" else views), (name, n)
    assert n["lgm"] == n["lpips"] == n["render.composite.backward"] // views
    (lo, hi), = [(s, e) for s, e, name in ranges if name == "loss_backward"]
    starts = []
    for name in BACKWARD:
        (s, e), = [(s, e) for s, e, m in ranges if m == name]
        assert lo <= s < e <= hi, name
        starts.append(s)
    assert starts == sorted(starts)
    # K2ᵇ's range lies inside the renderer's backward.
    (rs, re_), = [(s, e) for s, e, m in ranges if m == "render.backward"]
    assert all(rs <= s and e <= re_ for s, e, m in ranges
               if m == "render.composite.backward")
    c = trace.counters()
    assert c["composite_fwd.launches"] == c["composite_bwd.launches"] == views
    assert c["composite_fwd.pairs"] == c["composite_bwd.pairs"] > 0


def test_profiled_orbit_has_a_range_a_chunk(nano_step):
    opt = nano_step[0]
    g = sample_scene(np.random.default_rng(1), 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        frames = infer.render_orbit_video(g, opt, n_frames=180, chunk=30,
                                          device="cpu")
    assert frames.shape == (180, opt.output_size, opt.output_size, 3)
    n = Counter(name for _, _, name in _ranges(prof))
    assert n["render"] == n["orbit.to_host"] == 6
    assert n["render.composite"] == 180
    assert "render.backward" not in n
    c = trace.counters()
    assert c["composite_fwd.launches"] == 180
    assert "composite_bwd.launches" not in c


def test_untraced_step_builds_no_marker_and_no_counter(nano_step):
    opt, state, data, bg = nano_step
    out = state.model(data, bg)
    assert _markers(out["loss"]) == []
    out["loss"].backward()
    state.model.zero_grad(set_to_none=True)
    assert trace.counters() == {} and trace._device == {}
    with profile(activities=[ProfilerActivity.CPU]):
        traced = state.model(data, bg)
        # One marker on each side of the LGM, the renderer and LPIPS; the
        # LGM's inputs need no gradient, so it has no closing marker.
        assert sorted(_markers(traced["loss"])) == (
            ["_CloseBackward"] * 2 + ["_OpenBackward"] * 3)
        traced["loss"].backward()
    state.model.zero_grad(set_to_none=True)
    assert set(trace._device) == {torch.device("cpu")}


def test_lpips_backward_opens_and_closes_in_autograds_pass(nano_step,
                                                          monkeypatch):
    """LPIPS's VJP runs in its forward now: ``lpips.backward`` still opens
    and closes on autograd's thread, inside the backward pass, and holds
    no convolution (only the scale and the resize's backward), while the
    range ``lpips`` holds the convolutions' backward."""
    opt, state, data, bg = nano_step
    calls = []
    for name in ("open", "close"):
        real = getattr(trace.BackwardSpan, name)

        def spy(self, real=real, name=name):
            if self.name == "lpips.backward":
                calls.append((name, torch._C._current_graph_task_id()))
            return real(self)

        monkeypatch.setattr(trace.BackwardSpan, name, spy)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train.train_step(state, data, bg)
    assert [c for c, _ in calls] == ["open", "close"]
    assert all(task >= 0 for _, task in calls)  # inside autograd's pass
    events = [(ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
              for ev in prof.profiler.kineto_results.events()]
    (bs, be), = [(s, e) for s, e, m in events if m == "lpips.backward"]
    (fs_, fe), = [(s, e) for s, e, m in events if m == "lpips"]

    def ops(lo, hi, part):
        return [m for s, e, m in events
                if lo <= s and e <= hi and part in m]

    assert ops(bs, be, "convolution") == []
    assert ops(fs_, fe, "convolution_backward")


def test_lpips_graph_counts_captures_and_replays():
    fn = lambda a, b: (a.float() * b.float()).sum((1, 2, 3))  # noqa: E731
    a = torch.rand(2, 3, 4, 4).to(torch.bfloat16)
    graph = EagerGraph(fn, a, a, 4)
    graph(a, a)
    assert trace.counters() == {}  # untraced: nothing counted
    with profile(activities=[ProfilerActivity.CPU]):
        graph = EagerGraph(fn, a, a, 4)
        for _ in range(3):
            graph(a, a)
    assert trace.counters() == {"lpips.graph_captures": 1,
                                "lpips.graph_replays": 3}


def test_backward_range_is_not_closed_unopened():
    x = torch.ones(3, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bwd = trace.backward_span("t.backward")
        y, = bwd.outputs(bwd.inputs(x) * 2)
        bwd.close()  # never opened: nothing to close
        assert bwd.range is None
        y.sum().backward()
        assert bwd.range is None
    assert [m for _, _, m in _ranges(prof)] == ["t.backward"]
    assert torch.equal(x.grad, torch.full((3,), 2.0))


def _banded_view(R):
    """A 128² nano view's slots, and their counts, from 2,000 seeded
    splats (dup 16, cap 256): tiles that stop at their count, and tiles
    whose transmittance ends them early."""
    rng = np.random.default_rng(7)
    g = torch.as_tensor(sample_scene(rng, 2000))
    g[:, 3] = torch.as_tensor(rng.uniform(0.5, 1.0, 2000), dtype=g.dtype)
    view = torch.as_tensor(infer.orbit_video_cameras(
        get_config("nano"), 8)["cam_view"][1])
    tan = float(np.tan(0.5 * np.deg2rad(49.1)))
    with torch.no_grad():
        params, counts = fs._prepare_view(g, view, 128, tan, 1.0, 16, 16, 16,
                                          256, R == 10)
    return params, counts, (params, counts, 16, 16, 128 // 16)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("R", [9, 10])
def test_plain_composite_counts_what_composite_work_says(R, with_state):
    params, counts, args = _banded_view(R)
    T, MPT, _ = params.shape
    P = 16 * 16
    work = fs.composite_work(*args)
    assert 0 < work["slots"] < int(counts.sum())  # some tiles end early
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        res = fs.composite_fwd(*args, return_state=with_state)
    c = trace.counters()
    assert c["composite_fwd.launches"] == 1
    assert c["composite_fwd.pairs"] == work["pairs"] == work["slots"] * P
    fixed = 4 * T * (1 + 8 * P + (MPT // 128 * 6 * P if with_state else 0))
    assert c["composite_fwd.bytes"] - fixed == work["slots"] * R * 4
    out = res[0] if with_state else res
    assert torch.equal(out, fs.composite_reference(*args))


@pytest.mark.parametrize("given_state", [False, True])
def test_plain_composite_bwd_counts_the_forward_pairs(given_state):
    params, counts, args = _banded_view(9)
    T, MPT, R = params.shape
    P = 16 * 16
    out, state = fs.composite_reference(*args, return_state=True)
    go = torch.as_tensor(np.random.default_rng(3).normal(0, 1, out.shape),
                         dtype=torch.float32)
    work = fs.composite_work(*args)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        fs.composite_bwd(params, counts, out, go, *args[2:],
                         state=state if given_state else None)
    c = trace.counters()
    assert c["composite_bwd.launches"] == 1
    assert c["composite_bwd.pairs"] == work["pairs"]
    # Beyond its fixed counts and gradient rows: the slot rows it visits;
    # the state's T row of each chunk below a tile's count, the other five
    # of each live chunk, and fo's and go's rows 0-5 of each live tile.
    visited = work["tile_slots"]
    rows = (int(((counts.long() + 127) // 128).sum())
            + 5 * int(((visited + 127) // 128).sum())
            + 12 * int((visited > 0).sum()))
    assert c["composite_bwd.bytes"] - 4 * T * (1 + MPT * R) == (
        work["slots"] * R * 4 + rows * P * 4)


DIFFUSION_RANGES = ("diffusion.encode_prompt", "diffusion.encode_image",
                    "diffusion.encode_latents", "diffusion.decode",
                    "diffusion.denoise", "diffusion.step", "views")


class _TwoSteps:
    """A tiny ImageDream pipeline as ``image_to_views`` calls it, at 32²
    and two DDIM steps (the tiny U-Net would see 256² as 128² latents)."""

    def __init__(self, pipe):
        self.pipe = pipe

    def __call__(self, **kw):
        return self.pipe(**dict(kw, height=32, width=32,
                                num_inference_steps=2))


@pytest.fixture(scope="module")
def tiny_image_pipe():
    from lgm_tpu_torch.diffusion.pipeline import MVDreamPipeline

    pipe = MVDreamPipeline.from_config("tiny-pipe-ip", seed=0, device="cpu")
    rng = np.random.default_rng(3)
    image = rng.uniform(0, 1, (40, 40, 4)).astype(np.float32)
    image[..., 3] = 0.0
    image[8:30, 6:34, 3] = 1.0
    return _TwoSteps(pipe), image


def test_profiled_image_to_views_has_the_diffusion_ranges(tiny_image_pipe):
    pipe, image = tiny_image_pipe
    opt = get_config("nano")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        views = infer.image_to_views(pipe, image, opt)
    assert views.shape == (4, opt.input_size, opt.input_size, 3)
    ranges = _ranges(prof)
    n = Counter(name for _, _, name in ranges)
    assert {k: n[k] for k in DIFFUSION_RANGES} == dict(
        {k: 1 for k in DIFFUSION_RANGES}, **{"diffusion.step": 2})
    (lo, hi), = [(s, e) for s, e, m in ranges if m == "views"]
    (dlo, dhi), = [(s, e) for s, e, m in ranges if m == "diffusion.denoise"]
    assert all(lo <= s < e <= hi for s, e, m in ranges
               if m.startswith("diffusion."))
    assert all(dlo <= s < e <= dhi for s, e, m in ranges
               if m == "diffusion.step")
    assert trace.counters() == {"diffusion.steps": 2}


def test_untraced_image_to_views_makes_no_range_and_counts_nothing(
        tiny_image_pipe, monkeypatch):
    pipe, image = tiny_image_pipe
    opened = []
    real = trace._profiler.record_function

    def spy(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(trace._profiler, "record_function", spy)
    infer.image_to_views(pipe, image, get_config("nano"))
    assert opened == [] and trace.counters() == {}
