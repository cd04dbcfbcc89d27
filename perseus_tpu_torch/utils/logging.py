"""Local metrics logging with a wandb-style surface.

The port's copy of ``perseus_tpu/utils/logging.py``'s local path: ``init``
opens a run under ``outputs/runs/<id>/`` of the repository (or ``root``),
writes the serialized config to ``config.json`` and appends each ``log``
call to ``metrics.jsonl`` as one JSON record (``_step``, ``_time`` and the
metrics); ``finish`` closes it. ``generate_id`` draws wandb-style 8-char
run ids, which also name the run's checkpoint directory.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import string
import time
from typing import Any

__all__ = ["generate_id", "init", "log", "finish", "Run"]

_ACTIVE_RUN: "Run | None" = None


def generate_id(length: int = 8) -> str:
    alphabet = string.ascii_lowercase + string.digits
    return "".join(random.choices(alphabet, k=length))


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_jsonable(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): _to_jsonable(v) for k, v in obj.items()}
    if hasattr(obj, "item") and callable(obj.item):
        try:
            return obj.item()
        except (TypeError, ValueError, RuntimeError):  # not a one-element array
            return str(obj)
    if isinstance(obj, (int, float, str, bool)) or obj is None:
        return obj
    return str(obj)


class Run:
    def __init__(self, project: str, config: Any, run_id: str, root: str):
        self.project = project
        self.id = run_id
        self.dir = os.path.join(root, "outputs", "runs", run_id)
        os.makedirs(self.dir, exist_ok=True)
        with open(os.path.join(self.dir, "config.json"), "w") as f:
            json.dump({"project": project, "config": _to_jsonable(config)}, f, indent=2)
        self._file = open(os.path.join(self.dir, "metrics.jsonl"), "a", buffering=1)
        self._step = 0

    def log(self, metrics: dict) -> None:
        record = {"_step": self._step, "_time": time.time(), **_to_jsonable(metrics)}
        self._file.write(json.dumps(record) + "\n")
        self._step += 1

    def finish(self) -> None:
        self._file.close()


def init(project: str, config: Any = None, run_id: str | None = None, root: str | None = None) -> Run:
    global _ACTIVE_RUN
    from perseus_tpu_torch import ROOT

    _ACTIVE_RUN = Run(project, config, run_id or generate_id(), root or ROOT)
    return _ACTIVE_RUN


def log(metrics: dict) -> None:
    if _ACTIVE_RUN is not None:
        _ACTIVE_RUN.log(metrics)


def finish() -> None:
    global _ACTIVE_RUN
    if _ACTIVE_RUN is not None:
        _ACTIVE_RUN.finish()
        _ACTIVE_RUN = None
