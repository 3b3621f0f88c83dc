"""The harness on the CPU: what it loads, how it finds its pieces, how it
fails without a card, and a whole run at a tiny size."""

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark.harness import correct, spec
from benchmark.harness.run_cell import FORBIDDEN, run
from benchmark.tests._tiny import tiny

torch.set_num_threads(1)
BENCH = spec.BENCH
ROOT = spec.ROOT
CELLS = [w["name"] for w in spec.benchmark_json()["workloads"]]


def _python(code: str, cwd=ROOT, env=None, timeout=600):
    e = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(cwd), **(env or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=e, capture_output=True,
                          text=True, timeout=timeout)


DRIVE = """
import sys, time, json, torch
torch.set_num_threads(1)
from benchmark.tests._tiny import tiny
from benchmark.harness.run_cell import run
import benchmark.calibrate, benchmark.harness.trace
from benchmark.harness import spec
for m in spec.benchmark_json()["per_layer"] + spec.benchmark_json()["end_to_end"]:
    spec.reader(m["name"])
res = run(tiny("flagship.host_env"), 3, 0.1, True, "cpu", time.perf_counter(), lambda s: None)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_nothing_the_harness_runs_loads_jax_or_the_jax_package():
    out = _python(DRIVE)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)
    assert "eavit_tpu_torch" in top  # the program under test, whose name only begins alike


def test_the_reference_loads_nothing_of_the_program():
    out = _python("import sys, json\n"
                  "import benchmark.reference.follow, benchmark.reference.model\n"
                  "import benchmark.reference.prng, benchmark.reference.weights\n"
                  "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & (set(FORBIDDEN) | {"eavit_tpu_torch"})
    for f in sorted((BENCH / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] in {"__future__", "math", "typing", "torch",
                                           "benchmark"}, (f.name, n)
                assert not n.startswith("benchmark.") or n.startswith("benchmark.reference"), \
                    (f.name, n)


def test_every_file_loads_and_resolves():
    b = spec.benchmark_json()
    for c in b["configs"]:
        conf = spec.load_json(ROOT / c["file"])
        assert set(c["reduced"]) == set(conf["reduced"]) <= set(conf["published"])
        spec.work_model(conf["arch"]).policy_ops
    for w in b["workloads"]:
        cell = spec.cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        assert set(cell["limits"]) <= set(correct.NAMES) and cell["limits"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(spec.reader(m["name"]).read), m["name"]
        for cell in m.get("workloads", []):
            assert cell in CELLS
    for p in sorted((BENCH / "metrics").glob("[!_]*.py")):
        assert callable(spec.reader(p.stem).read)
    for name, group in spec.kernel_groups().items():
        assert group["patterns"] and "work" in group, name
    for p in sorted((BENCH / "workloads").glob("*.json")):
        spec.cell(p.stem)


def _tree_hash(root: Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_metric_and_kernel_group_are_new_files_only(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    os.symlink(ROOT / "eavit_tpu_torch", tmp_path / "eavit_tpu_torch")
    before = _tree_hash(tmp_path / "benchmark")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cell = json.loads((tmp_path / "benchmark/workloads/flagship.host_env.json").read_text())
    (tmp_path / "benchmark/workloads/flagship.extra.json").write_text(json.dumps(cell))
    b["workloads"].append({"name": "flagship.extra", "config": "flagship", "traffic": "host_env",
                           "chips": 1, "why": "a test cell"})
    (tmp_path / "benchmark/metrics/extra_ms.py").write_text(
        "def read(run):\n    return 1e3 * run.trace.group_time(run.groups['extra']['patterns'])"
        " or None if run.trace else None\n")
    (tmp_path / "benchmark/kernels/extra.json").write_text(
        json.dumps({"work": None, "patterns": ["*extra_kernel*"]}))
    b["per_layer"].append({"name": "extra_ms", "unit": "ms", "better": "lower",
                           "source": "device_trace", "layer": "kernels",
                           "moves": "frames_per_s", "workloads": ["flagship.extra"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    out = _python(
        "import json\nfrom benchmark.harness import spec\n"
        "c = spec.cell('flagship.extra')\n"
        "print(json.dumps([c['config_spec']['arch'], [m['name'] for m in "
        "spec.metrics_of('flagship.extra', True)], sorted(spec.kernel_groups()), "
        "spec.reader('extra_ms').__name__]))", cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    arch, metrics, groups, _ = json.loads(out.stdout.strip().splitlines()[-1])
    assert arch == "dual_token_vit" and "extra_ms" in metrics and "extra" in groups
    after = _tree_hash(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before


def test_no_card_fails_cleanly():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "flagship.host_env",
                          "--seed", "2147483711", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_no_card_and_no_program_fails_cleanly(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "hg.host_env",
                          "--seed", "5", "--seconds", "1", "--trace", "1"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_traced_run_reads_every_metric_it_can_on_the_cpu(name):
    res = run(tiny(name), 2 ** 31 + 3, 0.05, True, "cpu", time.perf_counter(), lambda s: None)
    data = res["data"]
    assert data.iterations >= 1 and data.trace is not None
    for m in spec.metrics_of(name, True):
        value = spec.reader(m["name"]).read(data)
        if m["source"] == "host_clock":
            assert value is not None and value > 0, m["name"]
    assert set(res["numbers"]) == set(correct.NAMES)
