"""Port parity: data-parallel training (perseus_tpu_torch/train/train.py) on
the CPU, two gloo ranks over localhost, against the JAX package's mesh.

Rank workers are subprocesses (tests/torch_dp_worker.py: one torch thread
each, free ports); the JAX side runs in the test process on conftest.py's
8-device CPU mesh, using 2 of its devices. Tolerances: three 2-rank steps
against JAX's 2-device-mesh step, as
tests/test_torch_train.py::test_three_train_steps_match_jax holds one card
(loss rel 1e-5, params and batch stats atol 1e-4), from one state with
AdamW moments well away from zero on both sides (torch_dp_worker.start_state:
no first-step sign flips; JAX's states are not shipped to the ranks, a
ResNet-18 state with its moments is 135 MB); the per-rank augmentation against
``make_sharded_augment`` as tests/test_round4_features.py holds it to its
per-shard serial run (images 1e-5, keypoints 1e-4); 2-rank ``train()``
against one rank stepping through the same global batches as
tests/test_distributed.py holds two JAX topologies (epoch-0 loss rel 2e-2,
final losses rel 0.2, params atol 5e-2; the first step's loss rel 1e-5),
with the global batches and the replicas bit for bit.
"""

import os
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from perseus_tpu.augment import fused as jfused
from perseus_tpu.augment import ops as jops
from perseus_tpu.augment.pipeline import AugmentationConfig as JAugConfig
from perseus_tpu.augment.pipeline import KeypointAugmentation as JAug
from perseus_tpu.models import resnet as jresnet
from perseus_tpu.train import train as jtrain
from perseus_tpu.train.config import TrainConfig as JTrainConfig
from perseus_tpu_torch import ROOT
from perseus_tpu_torch.augment.pipeline import AugmentationConfig, KeypointAugmentation
from perseus_tpu_torch.data.dataset import KeypointDatasetConfig, PrunedKeypointDataset
from perseus_tpu_torch.data.synthetic import generate_synthetic_decoded_split
from perseus_tpu_torch.models import convert
from perseus_tpu_torch.train import train
from perseus_tpu_torch.train.config import TrainConfig
from tests.test_torch_train import LR, OFF, _t
from tests.torch_dp_worker import digest, start_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, K, C = 8, 32, 8, 4
WORLD = 2
CASES = {
    "plain": {},
    "example_weights": dict(use_example_weights=True, example_weight_clip=1.5),
    "corner_weight": dict(outframe_corner_weight=0.25),
}
# the halves' means differ (1.4 and 2.0), so a rank-local normalisation
# gives another loss
WEIGHTS = np.asarray([0.1, 1.0, 4.0, 0.5, 2.0, 2.0, 3.0, 1.0], np.float32)
# the sharded augmentation's test: the chain's stages off (elementwise per
# image, held to JAX by tests/test_torch_augment.py), which keeps JAX's
# interpreted kernel quick to trace; transplant and affine, the per-shard
# parts, on
SHARD_AUG = dict(planckian_jitter=False, color_jiggle=False, blur=False, random_plasma_shadow=False,
                 random_erasing=False, random_bias=False, depth_gaussian_noise=False,
                 random_near_plane=False, random_far_plane=False)

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(work, init: str) -> list:
    """Starts WORLD rank workers; returns their Popen handles."""
    script = os.path.join(REPO, "tests", "torch_dp_worker.py")
    path = [REPO, *(p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(path), OMP_NUM_THREADS="1")
    port = str(_free_port())
    return [
        subprocess.Popen(
            [sys.executable, script, str(r), str(WORLD), port, str(work), init],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for r in range(WORLD)
    ]


def _join(procs, work) -> list:
    """Waits for the workers (each must print OK); returns their outputs."""
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"OK {r}" in log, f"rank {r} failed:\n{log}"
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]


def _batch():
    """Random 4-channel pixels (no pool ties), NHWC for JAX and NCHW for the
    port; per case the keypoints (partly out of frame for the corner
    weight, more of them in the second half) and the weights."""
    rng = np.random.default_rng(0)
    nhwc = rng.uniform(0, 1, (B, S, S, C)).astype(np.float32)
    nhwc[..., 3] = rng.uniform(3.0, 14.0, (B, S, S))
    inside = rng.uniform(2, S - 3, (B, K, 2)).astype(np.float32)
    outside = inside.copy()
    outside[B // 2 :, : K // 2] += 2 * S  # the second half's corners 0-3 out of frame
    outside[0, 0] -= 2 * S
    coords = {"plain": inside, "example_weights": inside, "corner_weight": outside}
    weights = {case: (WEIGHTS if opts.get("use_example_weights") else None) for case, opts in CASES.items()}
    return nhwc, np.ascontiguousarray(np.moveaxis(nhwc, -1, 1)), coords, weights


def _cfgs(opts):
    kw = dict(batch_size=B, in_channels=C, amp=False, learning_rate=LR, **opts)
    return (
        JTrainConfig(augmentation_config=JAugConfig(**OFF), **kw),
        TrainConfig(augmentation_config=AugmentationConfig(**OFF), **kw),
    )


def _to_jax_layout(key: str, v: torch.Tensor) -> np.ndarray:
    """A port tensor in the JAX package's layout (convert._to_torch_layout's inverse)."""
    v = v.numpy()
    return v.T if key == "fc.weight" else v.transpose(2, 3, 1, 0) if v.ndim == 4 else v


def _with_moments(node, mu, nu, count):
    """An optax state with its Adam moments and count replaced."""
    if hasattr(node, "mu") and hasattr(node, "nu"):
        return node._replace(mu=mu, nu=nu, count=jnp.asarray(count, node.count.dtype))
    if isinstance(node, tuple):
        kids = [_with_moments(c, mu, nu, count) for c in node]
        return type(node)(*kids) if hasattr(node, "_fields") else tuple(kids)
    return node


def _jax_steps(jcfg, cfg, nhwc, coords, weights):
    """Three steps of JAX's train step on a 2-device mesh, as train() jits
    it (replicated state, batch-sharded data), from start_state in JAX's
    layouts. Returns (losses, final state)."""
    mesh = jtrain.make_mesh(n_devices=WORLD)
    repl, shard = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    opt = jtrain.make_optimizer(jcfg)
    extra = (shard,) if weights is not None else ()
    step = jax.jit(
        jtrain.make_train_step(jcfg, opt, JAug(jcfg.augmentation_config, train=True), mesh=mesh),
        in_shardings=(repl, shard, shard, None) + extra, out_shardings=(repl, repl),
    )
    start = start_state(cfg)
    f32 = lambda d: {k: jnp.asarray(_to_jax_layout(k, v), jnp.float32) for k, v in d.items()}  # noqa: E731
    params = f32(start.params)
    o = start.opt_state
    jstate = jtrain.TrainState(params, f32(start.batch_stats),
                               _with_moments(opt.init(params), f32(o.exp_avg), f32(o.exp_avg_sq), o.step))
    back = _to_port(jstate)  # the bridge is exact
    assert back.opt_state.step == o.step
    assert all(torch.equal(back.params[k], v) and torch.equal(back.opt_state.exp_avg_sq[k], o.exp_avg_sq[k])
               for k, v in start.params.items())
    state = jax.device_put(jstate, repl)
    args = (jax.device_put(jnp.asarray(nhwc), shard), jax.device_put(jnp.asarray(coords), shard))
    args += (jax.device_put(jnp.asarray(weights), shard),) if weights is not None else ()
    losses = []
    for i in range(3):
        state, loss = step(state, args[0], args[1], jax.random.key(i), *args[2:])
        losses.append(float(loss))
    return losses, state


def _to_port(jstate):
    host = jax.tree.map(np.asarray, jstate)
    return convert.from_jax_train_state(host.params, host.batch_stats, host.opt_state, device="cpu")


def _run_dirs(run_ids):
    return [os.path.join(ROOT, "outputs", kind, r) for r in run_ids for kind in ("models", "runs")]


def _one_rank_train(cfg, monkeypatch):
    """1-rank train() in this process over the host loader: its summary,
    and its first batch and loss."""
    first = {}
    real = train.make_train_step

    def make_recording(*a, **kw):
        step = real(*a, **kw)

        def recorded(state, images_aug, coords, *rest, **kw2):
            new, loss = step(state, images_aug, coords, *rest, **kw2)
            first.setdefault("images", images_aug.clone())
            first.setdefault("coords", coords.clone())
            first.setdefault("loss", loss.item())
            return new, loss
        return recorded

    with monkeypatch.context() as m:
        m.setattr(train, "make_train_step", make_recording)
        res = train.train(cfg, device="cpu")
    return dict(history=res["train_loss_history"], final=res["final_train_loss"], val=res["final_val_loss"],
                params=res["state"].params, run_id=res["run_id"]), first


def _sharded_split_on_one_rank(cfg):
    """The device-resident run of WORLD ranks stepped on one rank: the whole
    split on one device, each step on the rows the ranks' shards give it
    (the JAX package's sharded split: shard d holds rows d * n_local ..., in
    its order from (seed, epoch, d)), through make_device_data_epoch_fn,
    then the val split through make_device_data_eval_step. The summary of
    _one_rank_train, and the first global batch (from the dataset) and
    loss."""
    ds = PrunedKeypointDataset(cfg.dataset_config, train=True, cache=True)
    val = PrunedKeypointDataset(cfg.dataset_config, train=False, cache=True)
    use_transplant = cfg.augmentation_config.random_transplantation_with_depth
    opt = train.make_optimizer(cfg)
    state = train.init_state(cfg, opt, "cpu")
    epoch_fn = train.make_device_data_epoch_fn(cfg, opt, KeypointAugmentation(cfg.augmentation_config))
    imgs, crds, _, _, n = train._device_dataset(ds, cfg, "cpu", use_transplant)
    n_local, lbs = n // WORLD, cfg.batch_size // WORLD
    steps = n_local // lbs
    history = []
    for epoch in range(cfg.n_epochs):
        perms = [d * n_local + np.random.default_rng((cfg.random_seed, epoch, d)).permutation(n_local)
                 for d in range(WORLD)]
        idx = np.stack([np.concatenate([p[s * lbs : (s + 1) * lbs] for p in perms]) for s in range(steps)])
        state, losses = epoch_fn(state, imgs, crds, torch.from_numpy(idx), cfg.random_seed, epoch * steps)
        history.append(losses.mean().item())
        if epoch == 0:
            batch = ds.batch(idx[0])
            first = dict(images=torch.from_numpy(train._prepare_aug_batch(batch, cfg.in_channels, use_transplant)),
                         coords=torch.from_numpy(np.asarray(batch["pixel_coordinates"], np.float32)),
                         loss=losses[0].item())
    v_imgs, v_crds, _, _, v_n = train._device_dataset(val, cfg, "cpu", False)
    eval_step = train.make_device_data_eval_step(cfg, KeypointAugmentation(cfg.augmentation_config, train=False))
    pairs = [eval_step(state, v_imgs, v_crds, i, m) for i, m in train.eval_index_batches(v_n, cfg.batch_size)]
    v = float(sum(p[0] for p in pairs) / sum(p[1] for p in pairs))
    return dict(history=history, final=history[-1], val=v, params=state.params, run_id=None), first


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """Everything this file compares, computed once: the two tcp:// rank
    workers (three steps per loss option, a refused batch, train() on both
    data paths) and, while they run, JAX's 2-device steps (one compile per
    option) and the one-rank runs in this process. The workers' files are
    deleted after the file's tests."""
    work = tmp_path_factory.mktemp("dp")
    nhwc, nchw, coords, weights = _batch()
    spec = {"images": torch.from_numpy(nchw), "coords": {}, "weights": {}, "step_cfgs": {}}
    for case, opts in CASES.items():
        spec["step_cfgs"][case] = _cfgs(opts)[1]
        spec["coords"][case] = torch.from_numpy(coords[case])
        spec["weights"][case] = None if weights[case] is None else torch.from_numpy(weights[case])

    # the random augmentation off: one rank and two draw from other
    # generators (rank 1's is its own), so only then are the two runs the
    # same computation on the same global batches; lr as the step tests'
    # (AdamW's sign flips at a rounding-level gradient move a param by up
    # to 2 lr, and the runs part from there)
    split = generate_synthetic_decoded_split(str(work / "split"), 32, 12, S, S, K)
    loop_cfg = TrainConfig(
        batch_size=B, n_epochs=2, learning_rate=LR, dataset_config=KeypointDatasetConfig(dataset_path=split),
        augmentation_config=AugmentationConfig(**OFF), in_channels=C, amp=False, cache_dataset=True, save_epochs=1,
    )
    spec["loop_cfg"] = loop_cfg
    torch.save(spec, work / "spec.pt")
    procs = _spawn(work, "tcp")
    run_ids = []
    try:
        ref = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jresnet, "MAXPOOL_CMP_VJP", True)  # g to every tie, as the port
            for case, opts in CASES.items():
                ref[case] = _jax_steps(*_cfgs(opts), nhwc, coords[case], weights[case])
        with pytest.MonkeyPatch.context() as mp:
            one = {"loader": _one_rank_train(loop_cfg, mp), "dd": _sharded_split_on_one_rank(loop_cfg)}
        run_ids.append(one["loader"][0]["run_id"])
        ranks = _join(procs, work)
        run_ids += [ranks[0]["train"][m]["run_id"] for m in ("loader", "dd")]
        written = {r: [os.path.isdir(d) for d in _run_dirs([r])] for r in run_ids}
        yield dict(ref=ref, ranks=ranks, one=one, split=split, cfg=loop_cfg, written=written)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for d in _run_dirs(run_ids) + [str(work)]:
            shutil.rmtree(d, ignore_errors=True)


@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_steps_match_jax_mesh(dp_run, case):
    """Three steps on two ranks against JAX's step on a 2-device mesh, from
    the same state: each step's loss, then the params and batch stats
    (global-batch BN, the global means of the example and corner weights,
    the mean gradient); the two replicas bit for bit."""
    losses, jstate = dp_run["ref"][case]
    got = [r["steps"][case] for r in dp_run["ranks"]]
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-5, err_msg=case)
    want = _to_port(jstate)
    for k, v in {**want.params, **want.batch_stats}.items():
        np.testing.assert_allclose(got[0]["state"][k].numpy(), v.numpy(), atol=1e-4, err_msg=f"{case} {k}")
    assert got[0]["losses"] == got[1]["losses"] and digest(got[0]["state"]) == got[1]["state"]


def test_rank_augmentation_matches_jax_sharded_augment():
    """The default (ultra) train augmentation, each rank on its half with
    the draws JAX's make_sharded_augment makes on that shard
    (fold_in(key, shard)): shard-local transplant donors, the images and
    keypoints of the 2-device mesh's call. The port's per-rank generators
    (step_generator's rank) are independent streams, rank 0's unchanged."""
    rng = np.random.default_rng(4)
    nhwc = rng.uniform(0, 1, (B, S, S, 5)).astype(np.float32)
    nhwc[..., 3] = rng.uniform(3.0, 14.0, (B, S, S))
    nhwc[..., 4] = rng.uniform(0, 1, (B, S, S)) < 0.4
    crds = rng.uniform(0, S - 1, (B, K, 2)).astype(np.float32)
    key = jax.random.key(7)
    mesh = jtrain.make_mesh(n_devices=WORLD)
    shard = NamedSharding(mesh, P("data"))
    jcfg = JAugConfig(**SHARD_AUG)
    with jax.enable_x64(False):  # JAX's draws in f32, as the port's
        fn = jtrain.make_sharded_augment(JAug(jcfg, train=True, fused=True), mesh)
        out_i, out_c = fn(key, jax.device_put(jnp.asarray(nhwc), shard), jax.device_put(jnp.asarray(crds), shard))
        draws = []
        for d in range(WORLD):
            keys = jax.random.split(jax.random.fold_in(key, d), 10)
            b = B // WORLD
            aff = jops.sample_affine_params(keys[1], b, S, S, degrees=jcfg.degrees, translate=jcfg.translate,
                                            scale=jcfg.scale, shear=jcfg.shear)
            fp = jfused.sample_fused_params(keys[2], jcfg, b, S, S, 5)
            draws.append({
                "donor_idx": _t(jops.sample_donor_indices(keys[0], b)),
                "affine": {k: _t(v) for k, v in aff.items()},
                "fused": {"scalars": _t(fp["scalars"]),
                          "fields": _t(fp["fields"].astype(jnp.float32)).to(torch.bfloat16),
                          "plasma": _t(fp["plasma"].astype(jnp.float32)).to(torch.bfloat16)},
            })
    aug = KeypointAugmentation(AugmentationConfig(**SHARD_AUG), train=True)
    nchw = torch.from_numpy(np.ascontiguousarray(np.moveaxis(nhwc, -1, 1)))
    parts = [aug.apply(nchw[d * 4 : d * 4 + 4], torch.from_numpy(crds[d * 4 : d * 4 + 4]), draws[d]) for d in range(WORLD)]
    images = torch.cat([p[0] for p in parts]).permute(0, 2, 3, 1).numpy()
    coords = torch.cat([p[1] for p in parts]).numpy()
    np.testing.assert_allclose(images, np.asarray(out_i), atol=1e-5)
    np.testing.assert_allclose(coords, np.asarray(out_c), atol=1e-4)

    a, b = (train.step_generator(0, 5, "cpu", r) for r in (0, 1))
    assert torch.equal(train.step_generator(0, 5, "cpu").get_state(), a.get_state())
    same = aug.sample(a, 4, S, S, 5)["affine"]["angle"], aug.sample(b, 4, S, S, 5)["affine"]["angle"]
    assert not torch.equal(*same)


@pytest.mark.parametrize("mode", ["loader", "dd"])
def test_two_rank_train_matches_one_rank(dp_run, mode):
    """2-rank train() against one rank on the same global batches (the
    equivalence tests/test_distributed.py holds between two JAX topologies).
    Host loader: against 1-rank train(), whose batches are the global ones.
    Device-resident split: each rank holds and steps through its own shard
    in its own order, as JAX's sharded split does, so the one rank steps
    through the global batches that layout gives (a rank holding the split
    whole would draw other batches). The first global batch (rank 0's rows,
    then rank 1's) bit for bit and its loss to rel 1e-5; the losses and
    params within the JAX test's tolerances (AdamW's first update parts
    the two where a gradient's sign is a rounding: tests/test_torch_train.py);
    the replicas bit for bit; rank 0 alone logging and saving; each real
    val row counted once (12 val rows, a global batch of 8)."""
    ranks = [r["train"][mode] for r in dp_run["ranks"]]
    one, one_first = dp_run["one"][mode]
    assert torch.equal(torch.cat([r["first"]["images"] for r in ranks]), one_first["images"])
    assert torch.equal(torch.cat([r["first"]["coords"] for r in ranks]), one_first["coords"])
    a, b = ranks
    assert a["first"]["loss"] == b["first"]["loss"]
    np.testing.assert_allclose(a["first"]["loss"], one_first["loss"], rtol=1e-5)

    assert a["run_id"] == b["run_id"] and a["history"] == b["history"] and a["val"] == b["val"]
    assert digest(a["state"]) == b["state"]
    assert a["calls"] == {"init": 1, "save": 2} and b["calls"] == {"init": 0, "save": 0}
    assert dp_run["written"][a["run_id"]] == [True, True]

    np.testing.assert_allclose(a["history"][0], one["history"][0], rtol=2e-2)
    np.testing.assert_allclose(a["final"], one["final"], rtol=0.2, atol=1e-3)
    np.testing.assert_allclose(a["val"], one["val"], rtol=0.2, atol=1e-3)
    for k, v in one["params"].items():
        assert torch.isfinite(a["state"][k]).all()
        np.testing.assert_allclose(a["state"][k].numpy(), v.numpy(), atol=5e-2, err_msg=k)


def test_two_rank_refuses_an_indivisible_batch(dp_run):
    for r in dp_run["ranks"]:
        assert "divisible by the number of ranks (2)" in r["refused"]


def test_env_rendezvous_and_disjoint_loader_shards(tmp_path):
    """torchrun's env:// rendezvous (bare distributed=True): a gloo group of
    two CPU ranks, an all-reduce across them, and the loader's shards of a
    12-row epoch disjoint and covering it."""
    ranks = _join(_spawn(tmp_path, "env"), tmp_path)
    for r, out in enumerate(ranks):
        assert out["group"] == (r, WORLD, "gloo", "cpu")
        assert out["all_reduce"] == [3.0, 3.0, 3.0]
    a, b = (set(out["shard"]) for out in ranks)
    assert not a & b and len(a) + len(b) == 12
