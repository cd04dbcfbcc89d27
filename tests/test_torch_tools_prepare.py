"""Port parity: the at-scale data preparation (tools/train_at_scale.py's
``prepare_dataset`` and ``prepare_decoded``, tools/prepare_at_scale.py)
against scripts/train_at_scale.py's ``prepare_dataset``, on the same six
port-rendered 32x32 jobs of 8 frames and two holdout-style ones.

Tolerances: the HDF5 route against the script's, file against file: the
names, asset ids, segmentation ratios, weights and attrs equal, the pixel
keypoints within 1e-4 px (both label in float64 and store f32: the JAX
labeler's projection, under the tests' x64, against the port's). The
decoded route, run in a process where ``h5py`` and ``PIL`` cannot be
imported, against ``schema.decode_pruned_dataset`` of the port's HDF5
route: every array equal in value, shape and dtype, the attrs equal, for
the main and the holdout split (train_frac 0.05: an empty train split).
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import h5py
import numpy as np
import pytest
import torch

from perseus_tpu_torch.data import schema
from perseus_tpu_torch.datagen.generate import VideoConfig, render_video, write_video
from perseus_tpu_torch.tools import prepare_at_scale as pas
from perseus_tpu_torch.tools import train_at_scale as tas

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, FRAMES, N_MAIN, N_HOLDOUT = 32, 8, 6, 2
SEG_UB = 0.15  # below some frames' segmentation ratios at this scene scale: the bounds drop rows


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses resolve their annotations there
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The videos rendered once on the CPU: written as job directories (the
    HDF5 route's input) and kept as arrays in an .npz (the decoded route's,
    for a process without PIL)."""
    root = tmp_path_factory.mktemp("tools_prepare")
    arrays, metas = {}, {}
    for kind, n, style, seed in (("jobs", N_MAIN, "train", 0), ("holdout_jobs", N_HOLDOUT, "holdout", 1)):
        cfg = VideoConfig(job_dir=str(root / kind), resolution=RES, frames=FRAMES, style=style, seed=seed)
        for i in range(n):
            job_id = f"{i:08x}"
            rgb, depth, seg, meta = render_video(cfg, job_id, device="cpu")
            os.makedirs(root / kind / job_id)
            write_video(str(root / kind / job_id), rgb, depth, seg, meta)
            for name, a in (("rgb", rgb), ("depth", depth), ("seg", seg)):
                arrays[f"{kind}/{job_id}/{name}"] = a.numpy()
            metas[f"{kind}/{job_id}"] = meta
    np.savez(root / "videos.npz", **arrays)
    with open(root / "metas.json", "w") as f:
        json.dump(metas, f)
    cfg = tas.ScaleRunConfig(job_dir=str(root / "jobs"), frames=FRAMES, holdout_job_dir=str(root / "holdout_jobs"),
                             seg_ub=SEG_UB)
    return root, cfg


@pytest.fixture(scope="module")
def hdf5_routes(jobs):
    """The port's HDF5 route (prepare_at_scale.prepare: main and holdout)
    and the script's prepare_dataset on the same jobs, each in its root."""
    root, cfg = jobs
    port = pas.prepare(dataclasses.replace(cfg, data_root=str(root / "port")))
    jscale = _script("train_at_scale")
    jcfg = jscale.ScaleRunConfig(job_dir=cfg.job_dir, data_root=str(root / "jax"), frames=FRAMES, seg_ub=SEG_UB)
    ho = jscale.ScaleRunConfig(job_dir=cfg.holdout_job_dir, data_root=str(root / "jax" / "holdout"), frames=FRAMES,
                               train_frac=0.05, seg_ub=SEG_UB)
    return port, (jscale.prepare_dataset(jcfg), jscale.prepare_dataset(ho))


def _read(path):
    with h5py.File(path, "r") as f:
        return dict(f.attrs), {s: {k: f[s][k][()] for k in f[s]} for s in ("train", "test")}


@pytest.mark.parametrize("which", [0, 1], ids=["main", "holdout"])
def test_hdf5_route_matches_the_script(hdf5_routes, which):
    port, jax_ = hdf5_routes
    assert port[which] is not None and port[which].endswith(os.path.join("pruned", "pruned.hdf5"))
    (pa, ps), (ja, js) = _read(port[which]), _read(jax_[which])
    assert pa.keys() == ja.keys() and all(np.array_equal(pa[k], ja[k]) for k in pa)
    kept = sum(len(ps[s]["image_filenames"]) for s in ps)
    assert 0 < kept < FRAMES * (N_MAIN, N_HOLDOUT)[which]  # the bounds kept some rows and dropped others
    for split in ("train", "test"):
        assert ps[split].keys() == js[split].keys()
        for k, v in ps[split].items():
            if k == "pixel_coordinates":
                np.testing.assert_allclose(v, js[split][k], atol=1e-4, rtol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(v, js[split][k], err_msg=k)
    if which == 1:
        assert len(ps["train"]["image_filenames"]) == 0  # train_frac 0.05 of 2 jobs


def test_decoded_route_without_h5py_and_pil_equals_the_hdf5_route(jobs, hdf5_routes, tmp_path):
    """As on the card's machine: with h5py and PIL blocked, the videos in
    memory go through prepare_decoded (the main split, then the holdout
    split's config); the result equals the HDF5 route decoded by
    schema.decode_pruned_dataset, array for array."""
    root, cfg = jobs
    data_root = tmp_path / "decoded_route"
    script = textwrap.dedent(
        f"""
        import sys
        sys.modules["h5py"] = None
        sys.modules["PIL"] = None
        import dataclasses, json
        import numpy as np
        from perseus_tpu_torch.tools import train_at_scale
        videos = np.load({str(root / "videos.npz")!r})
        with open({str(root / "metas.json")!r}) as f:
            metas = json.load(f)
        def jobs(kind, n):
            return [(f"{{i:08x}}", *(videos[f"{{kind}}/{{i:08x}}/{{a}}"] for a in ("rgb", "depth", "seg")),
                     metas[f"{{kind}}/{{i:08x}}"]) for i in reversed(range(n))]  # any order: sorted by job id
        cfg = train_at_scale.ScaleRunConfig(job_dir={cfg.job_dir!r}, frames={FRAMES}, data_root={str(data_root)!r},
                                            holdout_job_dir={cfg.holdout_job_dir!r}, seg_ub={SEG_UB})
        out = [train_at_scale.prepare_decoded(cfg, jobs("jobs", {N_MAIN})),
               train_at_scale.prepare_decoded(train_at_scale.holdout_config(cfg), jobs("holdout_jobs", {N_HOLDOUT}))]
        assert sys.modules["h5py"] is None and sys.modules["PIL"] is None
        print("prepared", json.dumps(out))
        """
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0 and "prepared" in out.stdout, out.stderr[-3000:]
    decoded = json.loads(out.stdout.split("prepared", 1)[1])
    assert decoded == [str(data_root / "decoded"), str(data_root / "holdout" / "decoded")]
    for i, (got_dir, hdf5) in enumerate(zip(decoded, hdf5_routes[0])):
        want_dir = schema.decode_pruned_dataset(hdf5, str(tmp_path / f"want{i}"))
        for train in (True, False):
            got, got_attrs, got_img = schema.read_decoded_split(got_dir, train)
            want, want_attrs, want_img = schema.read_decoded_split(want_dir, train)
            assert got_attrs == want_attrs
            for k in schema.PRUNED_DATASET_KEYS:
                a, b = np.asarray(getattr(got, k)), np.asarray(getattr(want, k))
                assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k
            for k in schema.IMAGE_KEYS:
                a, b = got_img[k], want_img[k]
                assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k


def test_prepare_decoded_refuses_an_existing_directory_unless_skip_prepare(jobs, tmp_path):
    _, cfg = jobs
    cfg = tas.ScaleRunConfig(data_root=str(tmp_path), frames=FRAMES)
    os.makedirs(tas.decoded_path(cfg))
    with pytest.raises(ValueError, match="already exists"):
        tas.prepare_decoded(cfg, [])
    schema.write_decoded_attrs(tas.decoded_path(cfg), {"H": RES, "W": RES})
    skip = tas.ScaleRunConfig(data_root=str(tmp_path), skip_prepare=True)
    assert tas.prepare_decoded(skip, []) == tas.decoded_path(cfg)  # reused, not rebuilt
    assert tas.prepared_split(skip) == tas.decoded_path(cfg)


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """The decoded route's command line from scratch: videos rendered in
    memory (here on the CPU) into the main and holdout decoded splits."""
    from perseus_tpu_torch.configs.cli import cli

    root = tmp_path_factory.mktemp("rendered")
    cfg = cli(pas.DecodedPrepareConfig, [
        "--scale.data-root", str(root), "--scale.frames", "6", "--videos.n-videos", "4",
        "--videos.resolution", "32", "--videos.frames", "6", "--holdout-videos.n-videos", "1",
        "--holdout-videos.resolution", "32", "--holdout-videos.frames", "6"])
    return root, cfg, pas.prepare_rendered(cfg, device="cpu")


def test_prepare_rendered_renders_straight_into_decoded_splits(rendered):
    """Both splits written, the holdout split all test rows (train_frac 0.05)."""
    root, _, (main_split, holdout) = rendered
    assert (main_split, holdout) == (str(root / "decoded"), str(root / "holdout" / "decoded"))
    rows = {}
    for name, path in (("main", main_split), ("holdout", holdout)):
        for train in (True, False):
            split, attrs, images = schema.read_decoded_split(path, train)
            assert attrs["H"] == attrs["W"] == 32 and images["image_u8"].shape == (len(split), 32, 32, 3)
            rows[name, train] = len(split)
    assert rows["main", True] >= 8 and rows["main", False] > 0
    assert rows["holdout", True] == 0 and rows["holdout", False] > 0


def test_train_at_scale_scores_a_prepared_holdout_split_without_its_jobs(rendered, tmp_path):
    """After the decoded route no holdout job directory exists: with
    skip_prepare, train_at_scale takes the splits under data_root and
    scores the holdout split prepared there (batch 8, 1 epoch)."""
    import shutil

    from perseus_tpu_torch import ROOT

    root, cfg, _ = rendered
    run = dataclasses.replace(cfg.scale, skip_prepare=True, epochs=1, batch_size=8, output_dir=str(tmp_path / "m"),
                              holdout_job_dir=str(tmp_path / "no_such_jobs"))
    out = tas.train_at_scale(run, device="cpu")
    try:
        m = out["metrics"]
        assert not [k for k in m if k.endswith("_error")], m
        assert m["holdout_style_n_frames"] == len(schema.read_decoded_split(str(root / "holdout" / "decoded"),
                                                                            False)[0])
        assert np.isfinite(m["holdout_style_rmse_px"]) and "pose_rmse_mm" not in m
    finally:
        for kind in ("models", "runs"):
            shutil.rmtree(os.path.join(ROOT, "outputs", kind, out["run_id"]), ignore_errors=True)
