"""Training metrics: stdout and ``logs/<exp>/metrics.csv``.

Counterpart of the JAX package's ``utils/logging.MetricLogger`` without
TensorBoard (the card's machine has none).  The CSV schema is declared up
front, so a metric that first appears mid-run does not rewrite the file,
and logging a metric outside it raises.  A fresh run truncates the file;
a resumed run appends to it, after one merge-rewrite under the union
header if the file on disk has another schema.  Under a process group
only rank 0 writes and prints (the metrics it logs are the ranks'
reduced ones); the other ranks' loggers do nothing.
"""
from __future__ import annotations

import csv
import os
import time
from typing import Dict, Optional

from .. import parallel

# every metric the training loop emits (train/step._loss_and_metrics with
# the gated steps' gate_frac, the driver's lr and the derived throughput
# columns below)
FIELDS = ("loss", "loss_c", "loss_f", "psnr", "psnr_c", "psnr_f", "lr",
          "gate_frac", "steps_per_sec", "rays_per_sec")


class MetricLogger:
    def __init__(self, logdir: str, exp_name: str, fresh: bool = False):
        self._csv_file = None
        if not parallel.is_main():
            return
        self.dir = os.path.join(logdir, exp_name)
        os.makedirs(self.dir, exist_ok=True)
        self.csv_path = os.path.join(self.dir, "metrics.csv")
        self._fields = sorted(FIELDS)
        if fresh and os.path.isfile(self.csv_path):
            os.remove(self.csv_path)   # a fresh run over a reused exp_name
        self._open_csv()
        self._last_step = 0
        self._last_time = time.time()

    def log(self, step: int, metrics: Dict[str, object],
            to_stdout: bool = False, n_rays: Optional[int] = None) -> None:
        if self._csv_file is None:
            return
        vals = {k: float(v) for k, v in metrics.items()}
        now = time.time()
        dstep = step - self._last_step
        if dstep > 0:
            vals["steps_per_sec"] = dstep / max(now - self._last_time, 1e-9)
            if n_rays:
                vals["rays_per_sec"] = vals["steps_per_sec"] * n_rays
        self._last_step, self._last_time = step, now
        self._csv_writer.writerow({"step": step, **vals})
        self._csv_file.flush()
        if to_stdout:
            parts = " , ".join(f"{k} : {v:.6g}" for k, v in vals.items())
            print(f"i : {step} , {parts}")

    def _open_csv(self) -> None:
        fieldnames = ["step"] + self._fields
        if os.path.isfile(self.csv_path):
            with open(self.csv_path, newline="") as f:
                existing = next(csv.reader(f), None)
            if existing == fieldnames:
                self._csv_file = open(self.csv_path, "a", newline="")
            else:
                # schema differs from the file's: one merge-rewrite, so old
                # rows stay aligned under the union header
                with open(self.csv_path, newline="") as f:
                    rows = list(csv.DictReader(f))
                self._fields = sorted(
                    (set(existing or ()) | set(fieldnames)) - {"step"})
                fieldnames = ["step"] + self._fields
                with open(self.csv_path, "w", newline="") as f:
                    w = csv.DictWriter(f, fieldnames=fieldnames, restval="",
                                       extrasaction="ignore")
                    w.writeheader()
                    w.writerows(rows)
                self._csv_file = open(self.csv_path, "a", newline="")
        else:
            self._csv_file = open(self.csv_path, "w", newline="")
            self._csv_file.write(",".join(fieldnames) + "\r\n")
            self._csv_file.flush()
        self._csv_writer = csv.DictWriter(
            self._csv_file, fieldnames=fieldnames, restval="")

    def close(self) -> None:
        if self._csv_file:
            self._csv_file.close()
            self._csv_file = None
