"""Experiment logging: a local JSONL event stream (hyperparams, scalars,
artifact pointers) -- greppable, diffable, no cloud dependency (the JAX
package's ``train/logging.py``; its Comet mirror is not ported).
"""

import json
import os
import time


class ExperimentLogger:
    def __init__(self, log_dir, exp_name="exp"):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "events.jsonl")
        self.exp_name = exp_name

    def _emit(self, kind, payload):
        rec = {"t": time.time(), "kind": kind, **payload}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def log_hyperparams(self, configs):
        self._emit("hyperparams", {"configs": configs})

    def log_metrics(self, step, metrics):
        self._emit("metrics", {"step": step, "metrics": {
            k: float(v) for k, v in metrics.items()}})

    def log_artifact(self, step, kind, path):
        self._emit("artifact", {"step": step, "artifact_kind": kind,
                                "path": path})
