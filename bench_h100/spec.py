"""The benchmark's data, found by name: ``BENCHMARK.json`` at the checkout's
root, each configuration's file and the architecture module its
``reference`` names, each traffic mix under ``traffic/``, each cell's
limits under ``limits/`` and each metric's reader under ``metrics/``.  A
cell added by files alone needs no change here."""

from __future__ import annotations

import functools
import hashlib
import importlib
import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the architecture module of a configuration without a ``reference`` key
LLAMA = "bench_h100/reference/model.py"


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)
    arch: ModuleType = None  # the configuration's architecture module


def architecture(config: dict) -> ModuleType:
    """The architecture module that the configuration's ``reference`` names:
    a path from the checkout's root (an absolute path as it is), imported
    once a process.  It exports ``layout``, ``MidiModel`` and the work
    counts (``bench_h100/README.md``)."""
    return _import(config.get("reference", LLAMA))


@functools.lru_cache(maxsize=None)
def _import(reference: str) -> ModuleType:
    path = (ROOT / reference).resolve()
    try:
        parts = path.relative_to(ROOT).with_suffix("").parts
    except ValueError:
        parts = ()
    if parts and all(p.isidentifier() for p in parts):
        return importlib.import_module(".".join(parts))
    name = "bench_arch_" + hashlib.sha1(str(path).encode()).hexdigest()[:16]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(f"no architecture module at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    sys.modules[name] = module
    return module


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT, bench: dict = None, here: Path = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = bench if bench is not None else load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"], config=config,
        traffic_name=w["traffic"], traffic=load_json(here / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(here / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
        arch=architecture(config))


def reader(metric: str, here: Path = HERE) -> Callable:
    """``read(run) -> number or None`` from ``metrics/<metric>.py``."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(metrics: List[dict], run, here: Path = HERE) -> Dict[str, dict]:
    """Each metric's reading by its reader; a reader that finds nothing to
    read returns None and the metric is left out."""
    out = {}
    for m in metrics:
        value = reader(m["name"], here)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
