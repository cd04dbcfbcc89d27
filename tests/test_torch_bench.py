"""The port's bench (perseus_tpu_torch/bench.py) against the root bench.py.

  * the harness: with every phase forced to fail, the line still comes, rc
    0, with the JAX line's keys (``bench._assemble_result({})``) and every
    measured field null; a forced failure of one phase run alone exits
    non-zero;
  * the scale-run selection and the metrics fold-in equal the JAX
    functions' on a fake ``outputs/models`` tree;
  * the chained bodies equal the same chains written as ``lax.scan``s over
    the JAX package, on the CPU: the detector chain (K = 3, 2 images of
    64x64, f32) to 1e-4 per step's mean (tests/test_torch_resnet.py's f32
    tolerance), the streaming chain (K = 3, 2 frames of 96x128, model
    64x64, f32, GN-4) to 1e-5 per translation (tests/test_torch_streaming.py's),
    and each chain's scalar to the sum of its terms' tolerances;
  * each phase runs inline on the CPU at a tiny size and gives a finite,
    positive number;
  * a cuda-marked test runs the whole bench on the card (it skips here).

JAX is imported inside the tests that compare with it, so that the file
also runs on the card's machine, which has none:
``python -m pytest tests/test_torch_bench.py -m cuda --noconftest``.
"""

import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from perseus_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEASURED = ("value", "vs_baseline", "smoother_p50_ms", "smoother_default_p50_ms", "streaming_ms_per_frame",
            "train_images_per_sec")
DETECTOR_ATOL = 1e-4  # f32 logits, tests/test_torch_resnet.py
TRANS_ATOL = 1e-5  # f32 smoothed translations, tests/test_torch_streaming.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: its tensors are small, and
    the suite runs several test processes side by side on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_bench():
    """The root bench.py, loaded from its path under another name."""
    spec = importlib.util.spec_from_file_location("jax_root_bench", os.path.join(REPO, "bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(*args, **env):
    return subprocess.run(
        [sys.executable, "-m", "perseus_tpu_torch.bench", *args], cwd=REPO, env=dict(os.environ, **env),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, timeout=300, text=True,
    )


def _last_json_line(stdout: str) -> dict:
    lines = [ln for ln in stdout.splitlines() if ln.strip().startswith("{")]
    assert lines, f"no JSON line in stdout: {stdout!r}"
    return json.loads(lines[-1])


def test_bench_emits_the_jax_line_when_all_phases_fail():
    proc = _run(PERSEUS_BENCH_FORCE_FAIL="all")
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1 + len(bench.PHASES) + 1  # the first, one per phase, the final
    result = _last_json_line(proc.stdout)
    jax_line = _jax_bench()._assemble_result({})
    assert set(result) == set(jax_line)
    assert list(result)[: len(MEASURED) + 2] == list(jax_line)[: len(MEASURED) + 2]
    assert result["metric"] == jax_line["metric"] == "detector_inference_fps_per_chip_256x256_rgbd"
    assert result["unit"] == jax_line["unit"] == "frames/sec/chip"
    for key in MEASURED:
        assert result[key] is None, key
    assert "forced failure" in proc.stderr


def test_bench_phase_reports_forced_failure():
    proc = _run("--phase", "detector", PERSEUS_BENCH_FORCE_FAIL="detector")
    assert proc.returncode != 0
    assert "forced failure" in proc.stderr


def _write_run(root, name, metrics, final=False):
    d = root / "outputs" / "models" / name
    d.mkdir(parents=True)
    (d / "metrics.json").write_text(metrics if isinstance(metrics, str) else json.dumps(metrics))
    if final:
        (d / "final").mkdir()


def test_scale_run_selection_and_fold_in_match_jax(tmp_path, monkeypatch):
    common = {"val_loss": 0.01, "epochs": 60, "n_train": 5000, "pose_rmse_mm": 9.0, "val_oof_frame_rate": None}
    # the lowest RMSE, no checkpoint and no pooled pose metric
    _write_run(tmp_path, "scale_run7", {**common, "val_rmse_px": 10.0, "val_p90_corner_err_px": 20.0})
    # a higher RMSE, with a checkpoint and the pooled pose metric
    _write_run(tmp_path, "scale_run6", {**common, "val_rmse_px": 12.0, "pose_multi_rmse_deg": 8.4,
                                        "pose_multi_rmse_mm": 17.9, "pose_multi_n_frames": 96}, final=True)
    _write_run(tmp_path, "scale_run5b", "{not json", final=True)
    _write_run(tmp_path, "scale_run5", {**common, "val_rmse_px": 11.0}, final=True)
    jb = _jax_bench()
    root = str(tmp_path)
    for require in (False, True):
        assert bench.select_scale_run(root, require) == jb._select_scale_run(root, require)
    assert bench.select_scale_run(root) == "scale_run7"
    assert bench.select_scale_run(root, require_checkpoint=True) == "scale_run5"
    monkeypatch.setattr(jb, "__file__", str(tmp_path / "bench.py"))
    folded = bench.read_scale_run_metrics(root)
    assert folded == jb.read_scale_run_metrics()
    assert folded["scale_run_name"] == "scale_run7" and folded["pose_multi_run_name"] == "scale_run6"
    assert folded["pose_multi_rmse_deg"] == 8.4 and "val_oof_frame_rate" not in folded
    assert bench.read_scale_run_metrics(str(tmp_path / "empty")) == {}
    # with a checkpoint selected, its final/ is a JAX orbax directory the port refuses: random init
    sd = bench.load_bench_weights(root)
    assert sd["conv1.weight"].shape == (64, 4, 7, 7) and sd["fc.weight"].shape == (16, 512)


@pytest.fixture(scope="module")
def jax_weights():
    """``init_keypoint_cnn(key(0), 8, 4)``, jitted (a third of the eager
    init's time here)."""
    import jax

    from perseus_tpu.models import resnet as jr

    return jax.jit(jr.init_keypoint_cnn, static_argnums=(1, 2))(jax.random.key(0), 8, 4)


def test_detector_chain_matches_jax_scan(jax_weights):
    import jax
    import jax.numpy as jnp

    from perseus_tpu.models import resnet as jr
    from perseus_tpu_torch.models import convert, resnet

    k = 3
    params, stats = jax_weights
    images = np.random.default_rng(0).uniform(0, 1, size=(2, 64, 64, 4)).astype(np.float32)
    folded_j = jr.fold_batchnorm(params, stats)

    @jax.jit
    def forward_chain(x):
        def body(x, _):
            out = jr.keypoint_cnn_apply_folded(folded_j, x, compute_dtype=jnp.float32)
            return x + jnp.mean(out) * 1e-9, jnp.mean(out)

        return jax.lax.scan(body, x, None, length=k)[1]

    means_j = np.asarray(forward_chain(jnp.asarray(images)))
    folded_t = resnet.fold_batchnorm(convert.from_jax_params(params, stats))
    means_t = bench.detector_chain(folded_t, torch.from_numpy(images).permute(0, 3, 1, 2).contiguous(), k,
                                   torch.float32)
    assert means_t.shape == (k,)
    np.testing.assert_allclose(means_t.numpy(), means_j, atol=DETECTOR_ATOL)
    assert abs(float(means_t.sum()) - float(means_j.sum())) <= k * DETECTOR_ATOL


def test_streaming_chain_matches_jax_scan(jax_weights):
    import jax
    import jax.numpy as jnp

    from perseus_tpu.runtime import streaming as js
    from perseus_tpu.smoother.lm import SmootherConfig as JaxSmootherConfig
    from perseus_tpu_torch.models import convert
    from perseus_tpu_torch.runtime import streaming
    from perseus_tpu_torch.smoother.lm import SmootherConfig

    k, gn4 = 3, dict(window=24, max_iterations=4, accept_reject=False)
    params, stats = jax_weights
    frames = np.random.default_rng(2).uniform(0, 1, size=(2, 96, 128, 4)).astype(np.float32)
    shape = dict(num_channels=4, model_h=64, model_w=64, amp=False, smooth=True)
    jpipe = js.StreamingPipeline(js.StreamingConfig(**shape, smoother=JaxSmootherConfig(**gn4)),
                                 params=params, batch_stats=stats)

    @jax.jit
    def run(c, fs):
        def body(carry_, i):
            c, bias = carry_
            f = jax.lax.dynamic_index_in_dim(fs, i % fs.shape[0], keepdims=False) + bias
            _, _, c2, pose = jpipe._step(f, c)
            return (c2, bias + jnp.sum(pose.trans) * 1e-12), pose.trans

        (c2, _), traces = jax.lax.scan(body, (c, jnp.float32(0.0)), jnp.arange(k))
        return traces, c2.window.trans

    traces_j, window_j = (np.asarray(a) for a in run(jpipe.init_carry(), jnp.asarray(frames)))
    tpipe = streaming.StreamingPipeline(streaming.StreamingConfig(**shape, smoother=SmootherConfig(**gn4)),
                                        convert.from_jax_params(params, stats), device="cpu")
    traces_t, carry_t = bench.streaming_chain(tpipe, torch.from_numpy(frames), tpipe.init_carry(), k)
    assert traces_t.shape == (k, 3)
    np.testing.assert_allclose(traces_t.numpy(), traces_j, atol=TRANS_ATOL)
    np.testing.assert_allclose(carry_t.window.trans.numpy(), window_j, atol=TRANS_ATOL)
    scalar_j = float(traces_j.sum() + window_j.sum())
    n_terms = traces_j.size + window_j.size
    assert abs(float(bench.chain_scalar(traces_t, carry_t)) - scalar_j) <= n_terms * TRANS_ATOL


PHASE_CASES = {
    "detector": (lambda: bench.bench_detector("cpu", batch=2, size=64, k=2, reps=1, warmups=1), ("fps",)),
    "smoother": (lambda: bench.bench_smoother("cpu", k=4, reps=1, warmup_k=0), ("p50", "p50_default")),
    "streaming": (lambda: bench.bench_streaming("cpu", k=2, reps=1, warmup_k=1, n_frames=2, frame_hw=(96, 128),
                                                model_hw=(64, 64)), ("ms",)),
    "train": (lambda: bench.bench_train("cpu", batch=8, size=64, k=2, reps=1, warmups=1), ("ips",)),
}


@pytest.mark.parametrize("phase", list(PHASE_CASES))
def test_phase_runs_inline_on_the_cpu(phase):
    run, fields = PHASE_CASES[phase]
    out = run()
    for field in fields:
        assert math.isfinite(out[field]) and out[field] > 0, (field, out)
    if "launches" in out:  # the wrappers count launches on the card only
        assert out["launches"] == dict.fromkeys(out["launches"], 0) and "max_pool_3x3_s2" in out["launches"]


@pytest.mark.cuda
def test_bench_line_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = _run()
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = _last_json_line(proc.stdout)
    for key in MEASURED:
        if key == "vs_baseline":
            assert result[key] is None
        else:
            assert result[key] is not None and math.isfinite(result[key]), (key, result)
    assert result["metric"] == "detector_inference_fps_per_chip_256x256_rgbd"
