"""A cell as `BENCHMARK.json` names it: its workload entry, its
configuration (`benchmark/configs/<config>.json`), its traffic mix
(`benchmark/traffic/<traffic>.json`) and its correctness limits
(`benchmark/limits/<workload>.json`), each found by name. A later cell
adds files and entries; it edits none of these.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Cell(NamedTuple):
    workload: Dict            # the BENCHMARK.json entry
    config: Dict              # benchmark/configs/<config>.json
    traffic: Dict             # benchmark/traffic/<traffic>.json
    limits: Dict              # benchmark/limits/<workload>.json
    end_to_end: list          # the end-to-end metrics the cell reports
    per_layer: list           # the per-layer metrics the cell reports


def _load(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, root: str = ROOT) -> Cell:
    """The cell `workload` of `root/BENCHMARK.json`; raises KeyError for a
    name the file does not list and OSError for a missing file."""
    bench = _load(os.path.join(root, "BENCHMARK.json"))
    entry = {w["name"]: w for w in bench["workloads"]}[workload]
    here = os.path.join(root, "benchmark")
    return Cell(
        workload=entry,
        config=_load(os.path.join(here, "configs", entry["config"] + ".json")),
        traffic=_load(os.path.join(here, "traffic",
                                   entry["traffic"] + ".json")),
        limits=_load(os.path.join(here, "limits", workload + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)])


def settings_from(config: Dict):
    """The port's Settings with every field the configuration lists, as
    data (not a call to the port's presets)."""
    from ssvio_tpu_torch.config import CameraConfig, Settings
    s = Settings()
    names = {f.name for f in dataclasses.fields(Settings)}
    for key, value in config["settings"].items():
        if key not in names:
            raise KeyError(f"{config['name']}: Settings has no field {key!r}")
        if key in ("cam_left", "cam_right"):
            value = CameraConfig(**value)
        setattr(s, key, value)
    return s
