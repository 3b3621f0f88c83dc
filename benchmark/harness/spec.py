"""Finding a cell's pieces by name.

Every piece that belongs to one configuration, one traffic mix, one cell,
one per-layer metric or one group of kernels sits in a file of its own under
``benchmark/``, found by the name that ``BENCHMARK.json`` or the cell gives:

- ``configs/<config>.json``: the model and training settings as run;
- ``traffic/<traffic>.json``: the env fleet and its size;
- ``workloads/<cell>.json``: the cell's configuration, traffic, chips and
  the limits of its correctness numbers;
- ``metrics/<metric>.py``: the reader of a metric (``read(run)``);
- ``kernels/<group>.json``: the kernel-name patterns of a roofline group;
- ``work/<arch>.py``: an architecture's operation and byte counts.

Adding one of them is adding a file; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Dict, List

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark_json() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> Dict[str, Any]:
    c = load_json(BENCH / "workloads" / f"{name}.json")
    c["name"] = name
    c["config_spec"] = load_json(BENCH / "configs" / f"{c['config']}.json")
    c["traffic_spec"] = load_json(BENCH / "traffic" / f"{c['traffic']}.json")
    return c


def metrics_of(cell_name: str, trace: bool) -> List[Dict[str, Any]]:
    """The metrics a run of ``cell_name`` reports: the end-to-end ones
    without tracing, the per-layer ones with it, each kept where its
    ``workloads`` list names the cell (or where it has none)."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in benchmark_json()[key]
            if "workloads" not in m or cell_name in m["workloads"]]


def reader(metric: str):
    """The module of ``metrics/<metric>.py`` (a name may hold dots)."""
    name = "benchmark.metrics." + metric.replace(".", "__")
    if name not in sys.modules:
        loader = importlib.util.spec_from_file_location(name, BENCH / "metrics" / f"{metric}.py")
        module = importlib.util.module_from_spec(loader)
        sys.modules[name] = module
        loader.loader.exec_module(module)
    return sys.modules[name]


def kernel_groups() -> Dict[str, Dict[str, Any]]:
    return {p.stem: load_json(p) for p in sorted((BENCH / "kernels").glob("*.json"))}


def work_model(arch: str):
    return importlib.import_module(f"benchmark.work.{arch}")
