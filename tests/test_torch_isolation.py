"""The port stands alone: perseus_tpu_torch and chip_smoke.py import neither
jax nor perseus_tpu, and its entry points never fall back to the CPU."""

import ast
import os

import pytest
import torch

from perseus_tpu_torch import resolve_device
from perseus_tpu_torch.models import convert
from perseus_tpu_torch.models.resnet import KeypointCNN
from perseus_tpu_torch.runtime.streaming import StreamingConfig, StreamingPipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "perseus_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "perseus_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    bad = [
        f"{os.path.relpath(p, REPO)}: {m}"
        for p in files
        for m in _imported_modules(p)
        if m.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    for call in (
        lambda: resolve_device(None),
        lambda: resolve_device("cuda"),
        lambda: KeypointCNN(num_channels=4),
        lambda: StreamingPipeline(StreamingConfig(num_channels=4), {}),
        lambda: convert.from_jax_train_state({}, {}, ()),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
