"""The port's spans (perseus_tpu_torch/utils/spans.py).

On the CPU: with spans off no record is made and ``span()`` is one shared
no-op object; with spans on, nested spans carry one id and their parents'
names, and their host times agree with their own ranges in a
``torch.profiler`` trace (host operations: none on the device's timeline); a tiny smoothed ``StreamingPipeline`` and a
tiny ``make_device_data_train_step`` yield their spans once a frame or a
step under one id, with outputs bit for bit those of spans off.

On the card (``cuda``-marked, skipped here; there run
``python -m pytest tests/test_torch_spans.py -m cuda --noconftest``): a
replay with spans on equals one with spans off bit for bit, its graph holds
the same kernel nodes as the spans-off graph (counted through
``CUDAGraph.raw_cuda_graph()``) and one pair of event nodes for the graph
and for each span inside it, and the in-graph spans' device times sum to
at most their replay's.
"""

import collections
import ctypes

import numpy as np
import pytest
import torch

from perseus_tpu_torch.augment.pipeline import AugmentationConfig, KeypointAugmentation
from perseus_tpu_torch.models import resnet
from perseus_tpu_torch.runtime.sources import SyntheticSource
from perseus_tpu_torch.runtime.streaming import StreamingConfig, StreamingPipeline
from perseus_tpu_torch.smoother.lm import SmootherConfig
from perseus_tpu_torch.train import train
from perseus_tpu_torch.train.config import TrainConfig
from perseus_tpu_torch.utils import spans

SERVE_SPANS = ("serve.frame", "graphed.copy_in", "graphed.replay", "graphed.clone_out", "serve.detector",
               "smoother.update", "smoother.solve")
SERVE_PARENTS = {"serve.frame": None, "graphed.copy_in": "serve.frame", "graphed.replay": "serve.frame",
                 "graphed.clone_out": "serve.frame", "serve.detector": "graphed.replay",
                 "smoother.update": "graphed.replay", "smoother.solve": "smoother.update"}
TRAIN_PARENTS = {"train.step": None, "augment.sample": "train.step", "augment.apply": "train.step",
                 "augment.apply.kernel": "augment.apply", "model.forward_backward": "train.step",
                 "optimizer.update": "train.step"}


@pytest.fixture(autouse=True)
def _spans_off_after():
    """Each test starts and ends with spans off and no records."""
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pipeline(device="cpu") -> StreamingPipeline:
    cfg = StreamingConfig(num_channels=4, model_h=64, model_w=64, amp=False,
                          smoother=SmootherConfig(window=4, max_iterations=2))
    model = resnet.KeypointCNN(n_keypoints=8, num_channels=4, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    return StreamingPipeline(cfg, model.state_dict(), device=device)


def _frames(n, h=96, w=128):
    source = SyntheticSource(height=h, width=w, depth=True, seed=3)
    return [source.get_frame() for _ in range(n)]


def _serve(pipe, frames):
    carry, out = pipe.init_carry(), []
    for f in frames:
        k, image, carry, pose = pipe(f, carry)
        out.append((k, image, pose))
    return torch.utils._pytree.tree_leaves((out, carry))


def _by_id(records):
    ids = collections.defaultdict(list)
    for r in records:
        ids[r.id].append(r)
    return list(ids.values())


def _profile(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return prof.profiler.kineto_results.events()


def test_off_makes_no_record_and_span_is_one_shared_no_op():
    off = spans.span("a", "cpu")
    assert off is spans.span("b") is spans.span("c", "cuda")
    assert not spans.enabled()

    def work():
        with off:
            torch.ones(3).sum()

    events = _profile(work)
    assert "a" not in {e.name() for e in events}  # the no-op, entered under a profiler, makes no event
    _serve(_pipeline(), _frames(2))
    assert spans.drain() == []


def test_off_spans_still_name_a_profiler_trace():
    """With spans off, a span entered while a profiler records is that
    profiler's host range of the same name (not a user annotation, which
    the profiler would also draw on the device's timeline), and leaves no
    record."""

    def work():
        with spans.span("outer"):
            with spans.span("inner", "cpu"):
                torch.ones(3).sum()

    events = {e.name(): e for e in _profile(work)}
    assert {"outer", "inner"} <= set(events)
    assert not any(events[n].is_user_annotation() for n in ("outer", "inner"))
    assert spans.drain() == []


def test_nested_spans_carry_one_id_and_their_parents():
    spans.enable()
    with spans.span("root", "cpu"):
        with spans.span("child", "cpu"):
            with spans.span("grandchild"):
                pass
        with spans.span("sibling", "cpu"):
            pass
    with spans.span("next"):
        pass
    records = spans.drain()
    assert [(r.name, r.parent) for r in records] == [
        ("grandchild", "child"), ("child", "root"), ("sibling", "root"), ("root", None), ("next", None)
    ]
    assert len({r.id for r in records[:4]}) == 1 and records[4].id != records[0].id
    by_name = {r.name: r for r in records}
    for r in records:
        assert r.host_start_ns <= r.host_end_ns
        if r.parent is not None:
            p = by_name[r.parent]
            assert p.host_start_ns <= r.host_start_ns and r.host_end_ns <= p.host_end_ns
    # on the CPU the device time is the host duration; a span with no device has none
    assert by_name["child"].device_ms == (by_name["child"].host_end_ns - by_name["child"].host_start_ns) / 1e6
    assert by_name["grandchild"].device_ms is None and by_name["next"].device_ms is None
    assert spans.drain() == []


def test_host_times_agree_with_the_profilers_own_ranges():
    def warm():
        with spans.span("warm"):
            pass

    _profile(warm)  # a process's first range takes longer to open
    spans.enable()

    def work():
        with spans.span("outer", "cpu"):
            for i in range(3):
                with spans.span(f"inner{i}", "cpu"):
                    torch.ones(64, 64) @ torch.ones(64, 64)

    events = {e.name(): e for e in _profile(work)}
    records = spans.drain()
    assert len(records) == 4
    for r in records:
        e = events[r.name]
        assert abs(e.start_ns() - r.host_start_ns) < 500_000 and abs(e.end_ns() - r.host_end_ns) < 500_000, r.name


def test_a_served_frame_yields_its_spans_once_and_the_same_outputs():
    frames = _frames(3)
    off = _serve(_pipeline(), frames)
    spans.enable()
    on = _serve(_pipeline(), frames)
    records = spans.drain()
    assert all(torch.equal(a, b) for a, b in zip(off, on)) and len(off) == len(on)
    per_frame = _by_id(records)
    assert len(per_frame) == len(frames)
    for frame in per_frame:
        assert sorted(r.name for r in frame) == sorted(SERVE_SPANS)
        assert {r.name: r.parent for r in frame} == SERVE_PARENTS
        assert all(r.device_ms is None if r.name == "serve.frame" else r.device_ms >= 0 for r in frame)


def _train_setup():
    cfg = TrainConfig(batch_size=2, in_channels=4, amp=False, input_resolution=32, n_keypoints=8,
                      augmentation_config=AugmentationConfig())
    opt = train.make_optimizer(cfg)
    aug = KeypointAugmentation(cfg.augmentation_config, train=True)
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (6, 5, 32, 32)).astype(np.float32)
    images[:, 3] = rng.uniform(3.0, 14.0, (6, 32, 32))
    images[:, 4] = rng.uniform(0, 1, (6, 32, 32)) < 0.3
    coords = rng.uniform(2, 29, (6, 8, 2)).astype(np.float32)
    return cfg, opt, aug, torch.from_numpy(images), torch.from_numpy(coords)


def _train_steps(n):
    cfg, opt, aug, images, coords = _train_setup()
    state = train.init_state(cfg, opt, device="cpu")
    step = train.make_device_data_train_step(cfg, opt, aug)
    losses = []
    for s in range(n):
        idx = torch.tensor([(2 * s) % 6, (2 * s + 1) % 6])
        state, loss = step(state, images, coords, idx, train.step_generator(7, s, "cpu"))
        losses.append(loss)
    opt_state = state.opt_state
    return torch.utils._pytree.tree_leaves(
        (state.params, state.batch_stats, opt_state.exp_avg, opt_state.exp_avg_sq, losses)
    ) + [torch.tensor(float(opt_state.step))]


def test_a_train_step_yields_its_six_spans_once_and_the_same_state():
    off = _train_steps(2)
    spans.enable()
    on = _train_steps(2)
    records = spans.drain()
    assert len(off) == len(on) and all(torch.equal(a, b) for a, b in zip(off, on))
    per_step = _by_id(records)
    assert len(per_step) == 2
    for step in per_step:
        assert sorted(r.name for r in step) == sorted(TRAIN_PARENTS)
        assert {r.name: r.parent for r in step} == TRAIN_PARENTS
        by_name = {r.name: r for r in step}
        inside = ("augment.sample", "augment.apply", "model.forward_backward", "optimizer.update")
        assert sum(by_name[n].device_ms for n in inside) <= by_name["train.step"].device_ms
        assert by_name["augment.apply.kernel"].device_ms <= by_name["augment.apply"].device_ms


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

CU_GRAPH_NODE_TYPE_KERNEL, CU_GRAPH_NODE_TYPE_EVENT_RECORD = 0, 7


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _graph_nodes(graph) -> tuple[collections.Counter, collections.Counter]:
    """(nodes by type, kernel nodes by function and launch shape) of a
    captured ``CUDAGraph`` (kept with ``keep_graph=True``), through
    libcuda's graph calls on ``raw_cuda_graph()``."""
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.cuGraphNodeGetType.restype = ctypes.c_int
    lib.cuGraphKernelNodeGetParams_v2.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.cuGraphKernelNodeGetParams_v2.restype = ctypes.c_int
    raw = graph.raw_cuda_graph()
    if not isinstance(raw, int):  # a capsule
        ctypes.pythonapi.PyCapsule_GetPointer.restype = ctypes.c_void_p
        ctypes.pythonapi.PyCapsule_GetPointer.argtypes = [ctypes.py_object, ctypes.c_char_p]
        raw = ctypes.pythonapi.PyCapsule_GetPointer(raw, None)
    n = ctypes.c_size_t(0)
    assert lib.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert lib.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0
    kinds, kernels = collections.Counter(), collections.Counter()
    for node in nodes:
        kind = ctypes.c_int()
        assert lib.cuGraphNodeGetType(node, ctypes.byref(kind)) == 0
        kinds[kind.value] += 1
        if kind.value == CU_GRAPH_NODE_TYPE_KERNEL:
            # CUDA_KERNEL_NODE_PARAMS_v2: func, 3 grid and 3 block dims, shared
            # bytes, (pad), kernelParams, extra, kern, ctx
            params = (ctypes.c_uint64 * 16)()
            assert lib.cuGraphKernelNodeGetParams_v2(node, params) == 0
            dims = np.frombuffer(bytes(params), np.uint32)[2:9]
            kernels[(params[0], params[7], *dims.tolist())] += 1
    return kinds, kernels


@pytest.mark.cuda
def test_a_replay_with_spans_on_is_the_spans_off_replay_with_event_nodes(monkeypatch):
    _need_cuda()
    real = torch.cuda.CUDAGraph
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: real(keep_graph=True))
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        frames = _frames(4)
        # every capture after a process's first holds the same four alloc and
        # four free nodes (the libraries' workspaces), spans on or off: one
        # capture first, so that both graphs compared are later ones
        _serve(_pipeline("cuda"), frames[:1])
        pipe = _pipeline("cuda")
        off = _serve(pipe, frames)
        spans.enable()
        _serve(pipe, frames[:1])  # captures the spans-on graph
        spans.drain()
        on = _serve(pipe, frames)
        torch.cuda.synchronize()
        records = spans.drain()
    finally:
        torch.backends.cudnn.deterministic = old
    assert pipe._step.graphs == 2
    assert len(off) == len(on) and all(torch.equal(a, b) for a, b in zip(off, on))
    caps = {key[-1]: cap for key, cap in pipe._step._captures.items()}
    (kinds_off, kernels_off), (kinds_on, kernels_on) = (_graph_nodes(caps[on_].graph) for on_ in (False, True))
    assert kernels_on == kernels_off and kinds_on[CU_GRAPH_NODE_TYPE_KERNEL] == kinds_off[CU_GRAPH_NODE_TYPE_KERNEL]
    inner = len(caps[True].spans.inner)
    assert inner == 3  # serve.detector, smoother.update, smoother.solve
    assert kinds_on - kinds_off == collections.Counter({CU_GRAPH_NODE_TYPE_EVENT_RECORD: 2 + 2 * inner})
    assert not kinds_off - kinds_on
    per_frame = _by_id(records)
    assert len(per_frame) == len(frames)
    for frame in per_frame:
        by_name = {r.name: r for r in frame}
        assert sorted(by_name) == sorted(SERVE_SPANS) and len(frame) == len(SERVE_SPANS)
        assert {r.name: r.parent for r in frame} == SERVE_PARENTS
        replay = by_name["graphed.replay"]
        assert replay.device_ms > 0 and by_name["graphed.copy_in"].device_ms > 0
        assert by_name["serve.detector"].host_start_ns is None
        assert 0 < by_name["serve.detector"].device_ms + by_name["smoother.update"].device_ms <= replay.device_ms
        assert 0 < by_name["smoother.solve"].device_ms <= by_name["smoother.update"].device_ms


@pytest.mark.cuda
def test_a_train_step_on_the_card_yields_its_spans_within_the_step():
    _need_cuda()
    cfg, opt, aug, images, coords = _train_setup()
    state = train.init_state(cfg, opt, device="cuda")
    step = train.make_device_data_train_step(cfg, opt, aug)
    images, coords = images.cuda(), coords.cuda()
    spans.enable()
    for s in range(3):
        state, _ = step(state, images, coords, torch.tensor([s, s + 1]), train.step_generator(7, s, "cuda"))
    records = spans.drain()
    per_step = _by_id(records)
    assert len(per_step) == 3
    for one in per_step:
        by_name = {r.name: r for r in one}
        assert {r.name: r.parent for r in one} == TRAIN_PARENTS
        inside = ("augment.sample", "augment.apply", "model.forward_backward", "optimizer.update")
        assert all(by_name[n].device_ms > 0 for n in TRAIN_PARENTS)
        assert sum(by_name[n].device_ms for n in inside) <= by_name["train.step"].device_ms
