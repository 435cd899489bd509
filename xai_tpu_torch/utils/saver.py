"""Experiment-directory saver (evaluations/utils/saver.py equivalent):
creates run directories with auto-incrementing experiment ids and persists
the run config + artifacts.

Counterpart of ``xai_tpu/utils/saver.py``.
"""
from __future__ import annotations

import json
import os
import shutil


class Saver:
    def __init__(self, base_dir: str, experiment_name: str = "experiment"):
        self.base_dir = base_dir
        os.makedirs(base_dir, exist_ok=True)
        runs = [d for d in os.listdir(base_dir)
                if d.startswith(experiment_name + "_")]
        ids = [int(d.rsplit("_", 1)[1]) for d in runs
               if d.rsplit("_", 1)[1].isdigit()]
        self.run_id = max(ids) + 1 if ids else 0
        self.experiment_dir = os.path.join(
            base_dir, f"{experiment_name}_{self.run_id}")
        os.makedirs(self.experiment_dir, exist_ok=True)

    def save_experiment_config(self, config: dict):
        with open(os.path.join(self.experiment_dir, "config.json"),
                  "w") as f:
            json.dump(config, f, indent=2, default=str)

    def save_file(self, path: str):
        shutil.copy(path, self.experiment_dir)

    def path(self, name: str) -> str:
        return os.path.join(self.experiment_dir, name)
