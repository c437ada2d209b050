"""Metrics and logging: JSONL always, throttled console lines, TensorBoard
when it imports.

Counterpart of ``pfpn_tpu/harness/metrics.py``: ``[TRAIN]`` console lines
throttled to one per ``console_interval`` seconds, ``metrics.jsonl`` in the
run's log directory, and TensorBoard summaries when
``torch.utils.tensorboard`` can be imported.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class MetricsLogger:
    def __init__(self, log_dir: str, console_interval: float = 10.0):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._last_console = 0.0
        self.console_interval = console_interval
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(log_dir)

    def log(self, step: int, metrics: Dict[str, float], prefix: str = ""):
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            key = f"{prefix}{k}"
            rec[key] = v if isinstance(v, int) else float(v)
            if self._tb is not None:
                self._tb.add_scalar(key, rec[key], int(step))
        self._write(rec)

    def log_histograms(self, step: int, arrays: Dict[str, np.ndarray],
                       prefix: str = ""):
        """Percentiles into the JSONL, full histograms into TensorBoard
        (metrics.py:32)."""
        rec = {"step": int(step), "time": time.time()}
        for k, v in arrays.items():
            arr = np.asarray(v).reshape(-1)
            if arr.size == 0:
                continue
            key = f"{prefix}{k}"
            rec[f"{key}/p5"], rec[f"{key}/p50"], rec[f"{key}/p95"] = (
                float(x) for x in np.percentile(arr, [5, 50, 95]))
            if self._tb is not None:
                self._tb.add_histogram(key, arr, int(step))
        self._write(rec)

    def _write(self, rec: dict):
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def console(self, tag: str, step: int, metrics: Dict[str, float],
                force: bool = False):
        now = time.time()
        if not force and now - self._last_console < self.console_interval:
            return
        self._last_console = now
        parts = " ".join(f"{k}: {v}" if isinstance(v, int) else f"{k}: {float(v):.4f}"
                         for k, v in metrics.items())
        print(f"[{tag}] step {int(step)} {parts} "
              f"{time.strftime('%m-%d %H:%M:%S')}", flush=True)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
