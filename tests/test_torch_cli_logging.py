"""Port parity: the dataclass CLI (perseus_tpu_torch/configs/cli.py) and the
local JSONL run logger (perseus_tpu_torch/utils/logging.py) against the JAX
package's, mirroring tests/test_cli_logging.py. Tolerance: none, the
parsed configs are equal field by field."""

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Tuple

import pytest

from perseus_tpu.configs.cli import parse_config as jparse_config
from perseus_tpu.train.config import TrainConfig as JTrainConfig
from perseus_tpu_torch.configs.cli import cli, parse_config
from perseus_tpu_torch.train import train
from perseus_tpu_torch.train.config import TrainConfig
from perseus_tpu_torch.utils import logging as ptlog


@dataclass(frozen=True)
class Inner:
    dataset_path: str = "data/pruned_dataset/pruned.hdf5"
    lazy: bool = True


@dataclass(frozen=True)
class Outer:
    batch_size: int = 256
    learning_rate: float = 1e-3
    translate: Tuple[float, float] = (0.1, 0.1)
    multigpu: bool = True
    dataset_config: Inner = field(default_factory=Inner)


@pytest.mark.parametrize(
    "argv",
    [
        [],
        ["--batch-size", "64", "--learning-rate", "3e-4"],
        ["--dataset-config.dataset-path", "/tmp/split", "--no-dataset-config.lazy"],
        ["--no-amp", "--data-on-device", "--device-data-dtype", "bfloat16"],
        ["--augmentation-config.translate", "0.2,0.3", "--augmentation-config.degrees", "30"],
        ["--batch-size=8", "--ema-decay=0.5", "--n-epochs", "3"],
        ["--multigpu", "false", "--cache-dataset", "--resume", "outputs/models/abc"],
        ["--augmentation-config.scale", "0.9 1.1", "--no-augmentation-config.blur", "--init-head"],
    ],
    ids=["defaults", "scalars", "nested", "bools", "tuples", "equals", "bool_value", "spaces"],
)
def test_train_config_matches_jax(argv):
    """The port's TrainConfig from argv equals the JAX package's, field by
    field, nested configs included."""
    got = dataclasses.asdict(parse_config(TrainConfig, argv))
    want = dataclasses.asdict(jparse_config(JTrainConfig, argv))
    assert got == want


def test_defaults_nested_bools_tuples():
    assert parse_config(Outer, []) == Outer()
    cfg = parse_config(Outer, ["--batch-size", "64", "--dataset-config.dataset-path", "/tmp/x.hdf5"])
    assert cfg.batch_size == 64 and cfg.dataset_config == Inner(dataset_path="/tmp/x.hdf5")
    cfg = parse_config(Outer, ["--no-multigpu", "--translate", "0.2,0.3"])
    assert cfg.multigpu is False and cfg.translate == (0.2, 0.3)
    assert parse_config(Outer, ["--multigpu", "false"]).multigpu is False
    assert cli(Outer, ["--batch-size=8"]) == jparse_config(Outer, ["--batch-size=8"])


@pytest.mark.parametrize("argv", [["--bogus", "1"], ["--batch-size"], ["stray"]], ids=["unknown", "no_value", "positional"])
def test_bad_argv_exits_as_jax(argv):
    with pytest.raises(SystemExit) as got:
        parse_config(Outer, argv)
    with pytest.raises(SystemExit) as want:
        jparse_config(Outer, argv)
    assert str(got.value).split("\n")[0] == str(want.value).split("\n")[0]


def test_help_lists_every_flag(capsys):
    with pytest.raises(SystemExit) as exc:
        parse_config(TrainConfig, ["--help"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    assert "--dataset-config.dataset-path" in out and "--augmentation-config.random-affine" in out


def test_local_logger_writes_jsonl(tmp_path):
    run = ptlog.init("test-project", config=Outer(), run_id="abc12345", root=str(tmp_path))
    assert run.id == "abc12345"
    ptlog.log({"loss": 1.5})
    ptlog.log({"val_loss": 0.5, "lr": 1e-3})
    ptlog.finish()
    ptlog.log({"loss": 9.0})  # no active run: dropped
    run_dir = os.path.join(str(tmp_path), "outputs", "runs", "abc12345")
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["project"] == "test-project" and cfg["config"]["dataset_config"]["lazy"] is True
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [(r["_step"], r.get("loss"), r.get("val_loss")) for r in lines] == [(0, 1.5, None), (1, None, 0.5)]
    ids = {ptlog.generate_id() for _ in range(20)}
    assert len(ids) == 20 and all(len(i) == 8 and i.isalnum() and i == i.lower() for i in ids)


def test_main_parses_the_command_line_into_train(monkeypatch):
    """``python -m perseus_tpu_torch.train.train --flags``: main() hands
    train() the TrainConfig of the flags."""
    seen = []
    monkeypatch.setattr(train, "train", lambda cfg: seen.append(cfg))
    monkeypatch.setattr("sys.argv", ["train", "--dataset-config.dataset-path", "/data/split", "--n-epochs", "3"])
    train.main()
    assert seen == [TrainConfig(n_epochs=3, dataset_config=dataclasses.replace(TrainConfig().dataset_config, dataset_path="/data/split"))]
