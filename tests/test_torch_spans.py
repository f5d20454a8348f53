"""The program's spans (``wct_tpu_torch.utils.profiling.span``): free with
no profiler running, and under ``torch.profiler`` each route's set of
ranges, properly nested under ``wct.stylize`` › ``wct.level.<relu>``,
with a summary whose self times add up."""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from wct_tpu_torch.models import cascade
from wct_tpu_torch.utils import profiling
from wct_tpu_torch.utils.stream import StreamStylizer

SIZE = 64
LEVELS = {f"wct.level.{t}" for t in cascade.DEFAULT_TARGETS}
STAGES = {"wct.encode", "wct.transform", "wct.decode"}
OPS = {"wct.op.conv", "wct.op.gram", "wct.op.sqrt"}
# The eigh routes' matrix powers open wct.op.eigh inside wct.op.sqrt.
F32 = STAGES | OPS | {"wct.op.eigh"}
FUSED = STAGES | OPS | {"wct.junction", "wct.op.head", "wct.op.junction", "wct.op.tail"}

# Route → (CascadeConfig fields, the spans below wct.level.* it emits).
ROUTES = {
    "f32": ({}, F32),
    "bf16_fused": (dict(compute_dtype="bfloat16", method="newton_schulz_fast",
                        fuse_junction=True), FUSED),
    "pack2": (dict(pack2_junction=True), F32 | {"wct.junction"}),
    "fold": (dict(fold_transform=True), F32),
    "adain": (dict(transform="adain"), STAGES | {"wct.op.conv", "wct.op.gram"}),
    "swap5": (dict(swap5=True), F32),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs in
    parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fresh_summary():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    params = cascade.init_params(0, device="cpu")
    content = torch.as_tensor(rng.random((2, SIZE, SIZE, 3), np.float32))
    style = rng.random((SIZE, SIZE, 3)).astype(np.float32)
    return params, content, style


def _run(setup, **kw):
    params, content, style = setup
    cfg = cascade.CascadeConfig(**kw)
    cache = cascade.precompute_style(params["encoder"], style, cfg)
    return cascade.stylize(params, content, cache, 0.6, cfg)


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.startswith("wct.")]


def _ancestors(event) -> list[str]:
    names, e = [], event.cpu_parent
    while e is not None:
        names.append(e.name)
        e = e.cpu_parent
    return names


def _assert_nested(events):
    """The ranges of each thread nest properly: each lies inside the one
    open at its start, or starts after it ends."""
    by_thread: dict = {}
    for e in events:
        by_thread.setdefault(e.thread, []).append((e.time_range.start, e.time_range.end, e.name))
    for ranges in by_thread.values():
        stack = []
        for start, end, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
            while stack and stack[-1][1] <= start:
                stack.pop()
            assert not stack or end <= stack[-1][1], (name, stack[-1])
            stack.append((start, end, name))


def test_span_makes_no_torch_call_with_the_profiler_off(setup, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", refuse)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="record_function entered"):
            with profiling.span("wct.check"):
                pass
    profiling.reset_spans()
    out = _run(setup, **ROUTES["bf16_fused"][0])
    assert out.shape == (2, SIZE, SIZE, 3)
    assert profiling.span_totals() == {}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_each_route_emits_its_spans_nested_under_its_levels(setup, route):
    kw, below = ROUTES[route]
    _, events = _profiled(lambda: _run(setup, **kw))
    inside = [e for e in events if e.name != "wct.precompute_style"
              and "wct.precompute_style" not in _ancestors(e)]
    names = {e.name for e in inside}
    assert names == {"wct.stylize"} | LEVELS | below, route
    for e in inside:
        chain = _ancestors(e)
        assert not chain or chain[0] != e.name, e.name  # one range per entry's call
        if e.name == "wct.stylize":
            assert not any(n.startswith("wct.") for n in chain)
        elif e.name in LEVELS:
            assert chain[0] == "wct.stylize", (e.name, chain)
        elif e.name == "wct.op.eigh":
            assert chain[0] == "wct.op.sqrt", chain
        else:
            assert "wct.stylize" in chain and LEVELS & set(chain), (e.name, chain)
    assert sum(e.name == "wct.stylize" for e in inside) == 1
    assert {e.name for e in events} >= {"wct.precompute_style"}
    _assert_nested(events)


def test_self_times_add_up(setup):
    _profiled(lambda: _run(setup))
    t = profiling.span_totals()
    total = {name: row["total_ns"] for name, row in t.items()}
    own = {name: row["self_ns"] for name, row in t.items()}
    assert t["wct.stylize"]["calls"] == 1
    assert all(t[name]["calls"] == 1 for name in LEVELS)
    assert total["wct.stylize"] == own["wct.stylize"] + sum(total[n] for n in LEVELS)
    assert sum(total[n] for n in LEVELS) == sum(own[n] for n in LEVELS) + sum(
        total[n] for n in STAGES)
    # The ops run under the stages, and the style's under its precompute.
    parents = STAGES | {"wct.precompute_style"}
    assert sum(total[n] for n in parents) == sum(own[n] for n in parents) + sum(
        total[n] for n in ("wct.op.conv", "wct.op.gram", "wct.op.sqrt"))
    assert total["wct.op.sqrt"] == own["wct.op.sqrt"] + total["wct.op.eigh"]
    assert all(0 <= row["self_ns"] <= row["total_ns"] for row in t.values())


@pytest.mark.parametrize("route", ["f32", "bf16_fused"])
def test_outputs_are_bitwise_the_same_under_the_profiler(setup, route):
    kw = ROUTES[route][0]
    plain = _run(setup, **kw)
    traced, _ = _profiled(lambda: _run(setup, **kw))
    assert torch.equal(plain, traced)


def test_stream_stages_are_spans_without_a_sync(setup, monkeypatch):
    params, content, style = setup

    def refuse(*args, **kwargs):
        raise AssertionError("the stream synchronised")

    monkeypatch.setattr(profiling, "device_sync", refuse)
    cfg = cascade.CascadeConfig(relu_targets=("relu2_1", "relu1_1"))
    eng = StreamStylizer(params, cfg, SIZE, SIZE, readback="uint8", frame_batch=2)
    eng.set_style(style)
    frames = content.numpy()

    def serve():
        outs = [eng.process(frames[0])]
        for f in frames:
            eng.submit(f)
        while (out := eng.collect()) is not None:
            outs.append(out)
        return outs

    outs, events = _profiled(serve)
    assert len(outs) == 3
    stages = {"wct.stream." + s for s in ("resize", "host_prep", "h2d", "device", "d2h",
                                          "host_post")}
    assert stages <= {e.name for e in events}
    device = [e for e in events if e.name == "wct.stream.device"]
    assert device and all("wct.stylize" in {c.name for c in e.cpu_children} for e in device)
    _assert_nested(events)


def test_trace_writes_the_blocks_span_summary(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("wct.before"):
            pass
    with profiling.trace(str(tmp_path), device="cpu"):
        with profiling.span("wct.outer"):
            with profiling.span("wct.inner"):
                _ = torch.ones(8) + 1
    spans = json.loads((tmp_path / "spans.json").read_text())
    assert set(spans) == {"wct.outer", "wct.inner"}
    assert spans["wct.outer"]["calls"] == spans["wct.inner"]["calls"] == 1
    assert spans["wct.outer"]["total_ns"] == (spans["wct.outer"]["self_ns"]
                                              + spans["wct.inner"]["total_ns"])
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"wct.outer", "wct.inner"} <= names


def test_threads_keep_their_own_nesting_and_lose_no_call():
    """Eight threads open nested spans at once under the profiler: each
    thread's self times come from its own stack, and no call is lost."""
    per_thread, threads = 300, 8

    def work():
        for _ in range(per_thread):
            with profiling.span("wct.outer"):
                with profiling.span("wct.inner"):
                    pass

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in pool)
    spans = profiling.span_totals()
    assert spans["wct.outer"]["calls"] == spans["wct.inner"]["calls"] == per_thread * threads
    assert spans["wct.outer"]["total_ns"] == (spans["wct.outer"]["self_ns"]
                                              + spans["wct.inner"]["total_ns"])
