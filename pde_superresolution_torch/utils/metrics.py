"""Structured JSONL metrics logging, with optional TensorBoard mirroring.

The replacement for the reference's tf.summary event files
(SURVEY.md §5 "Metrics / logging"): newline-delimited JSON records that any
tool can tail/parse, written from the host side of the training loop. Pass
``tensorboard_dir`` to ALSO mirror every scalar into TensorBoard event
files (≈ the reference's tf.summary behavior), written by the in-repo
dependency-free event writer (utils/tb_events.py) — no TensorFlow or torch
import on the logging path.
"""

from __future__ import annotations

import json
import os
import time
from typing import IO, Optional

from pde_superresolution_torch.utils.tb_events import EventWriter


class MetricsLogger:
    """Append-only JSONL metrics writer (no-op when both paths are None)."""

    def __init__(
        self,
        path: Optional[str] = None,
        tensorboard_dir: Optional[str] = None,
    ):
        self._file: Optional[IO[str]] = None
        self._tb = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._file = open(path, "a")
        if tensorboard_dir:
            self._tb = EventWriter(tensorboard_dir)
        self._start = time.time()

    def log(self, step: int, **values) -> None:
        if self._file is None and self._tb is None:
            return
        record = {
            "step": step,
            "wall_time": round(time.time() - self._start, 3),
        }
        for key, value in values.items():
            try:
                record[key] = float(value)
            except (TypeError, ValueError):
                record[key] = value
        if self._file is not None:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        if self._tb is not None:
            for key, value in record.items():
                if key != "step" and isinstance(value, float):
                    self._tb.add_scalar(key, value, global_step=step)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
