"""A cell from its name: the manifest's entry, its configuration file, its
traffic mix (`bench/traffic/<traffic>.json`), its limits
(`bench/limits/<workload>.json`) and the per-layer metrics that list it
(`bench/metrics/<metric>.py`).  Everything that belongs to one
configuration, mix, cell or metric is a file of its own, found by name."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict          # the configuration file
    traffic: dict         # the mix
    limits: dict          # {number: limit}
    end_to_end: list      # the manifest's metrics this cell reports
    per_layer: list

    @property
    def model(self) -> dict:
        return self.config["model"]


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """A per-layer metric is read in the cells it lists, or else in every
    cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load(name: str, root: Path = ROOT) -> Cell:
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if name not in by_name:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(by_name)}")
    w = by_name[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if _reports(m, name, names)]
    return Cell(name, w, config, traffic, limits, e2e, per_layer)


def reader(metric: str):
    """The `read(run)` function of bench/metrics/<metric>.py."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
