"""Small cells for the tests on the CPU: a copy of the benchmark's folder
with 41 x 41 configurations of each family, three shots, short records,
and the models they read, in a temporary directory."""
from __future__ import annotations

import json
import os
import shutil

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

CONFIG = {"model_dir": "TINY", "true_model": "vp.true",
          "start_model": "vp.smooth_20", "shape": [41, 41],
          "spacing": [30.0, 30.0], "nbl": 10, "space_order": 8, "tn": 400.0,
          "f0": 0.01, "shots": 3, "depth_cells": 2, "water_rows": 3,
          "water_vp": 1.5, "vp_bounds": [1.5, 5.2], "precision": "float32",
          "reduced": [], "assumed": {}}
# the tiny cells' own limits, between what sound runs read on the CPU
# (1e-7 - 3e-5) and what the bfloat16 control reads (7e-5 - 8e-3)
LIMITS = {"f0": 5e-5, "grad0": 2e-4, "trials": 2e-4, "step": 2e-4,
          "f1": 5e-5, "grad1": 5e-4}
CELLS = {"tiny-acoustic": dict(CONFIG, family="acoustic", dt=2.95),
         "tiny-elastic": dict(CONFIG, family="elastic")}


def models(shape):
    """A water layer over two rock layers and its smoothed start."""
    nx, nz = shape
    z = np.arange(nz)[None, :].repeat(nx, 0)
    true = np.where(z < 3, 1500.0, np.where(z < 20, 2200.0, 3000.0))
    true[15:25, 25:32] = 2600.0
    k = np.ones(9) / 9
    smooth = np.apply_along_axis(lambda c: np.convolve(
        np.pad(c, 4, mode="edge"), k, "valid"), 1, true)
    smooth[:, :3] = 1500.0
    return true.astype(np.float32), smooth.astype(np.float32)


def make(tmp, seconds_trace=(1, 1)):
    """A checkout-like tree under ``tmp``: (root, here, data_dir)."""
    here = os.path.join(tmp, "fwibench")
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns(
        "_runs", "__pycache__", "tests"))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for name, cfg in CELLS.items():
        with open(os.path.join(here, "configs", name + ".json"), "w") as f:
            json.dump(dict(cfg, name=name), f)
        work = json.load(open(os.path.join(
            here, "workloads", "smarmn-l2-lbfgs.json")))
        work.update(name=name, config=name,
                    trace={"skip_iterations": seconds_trace[0],
                           "iterations": seconds_trace[1]})
        work["check"]["limits"] = LIMITS
        with open(os.path.join(here, "workloads", name + ".json"), "w") as f:
            json.dump(work, f)
        spec["workloads"].append({"name": name, "config": name,
                                  "traffic": name, "chips": 1, "why": name})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "workloads" in m and cfg["family"] in m["name"] \
                    or m["name"] in ("host_loop_ms", "trials_per_iter",
                                     "glue_ms.gradient", "device_idle_pct",
                                     "gradient_mfu_pct", "gradient_p90_ms"):
                m["workloads"].append(name)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    data = os.path.join(tmp, "model_data", "TINY")
    os.makedirs(data)
    true, smooth = models(CONFIG["shape"])
    true.tofile(os.path.join(data, "vp.true"))
    smooth.tofile(os.path.join(data, "vp.smooth_20"))
    return tmp, here, os.path.join(tmp, "model_data")
