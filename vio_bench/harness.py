"""What every run does, whatever the cell: find the cell, its configuration,
traffic and limits by name; refuse without the cards it asks for; hand the
entry module its inputs; judge what the timed path produced against the limits;
read the per-layer metrics; refuse if JAX or the JAX package was loaded;
print the result.

An entry module (``entries/<entry>.py``, the traffic file's ``entry``) has
``run(cfg, traffic, seed, seconds, trace, t_start, device) -> Run``.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mobile_slam_tpu")
CACHE_ENV = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton"}


@dataclasses.dataclass
class Run:
    """What an entry module hands back. ``e2e``: end-to-end metric values;
    ``records``: what the per-layer readers read (the trace's records and
    the entry module's own); ``checks``: {name: value compared} (None: no number);
    ``attempted`` / ``failed``: requests of the window and those without a
    good answer."""

    e2e: dict
    records: dict
    checks: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    notes: list = dataclasses.field(default_factory=list)


def load_json(*parts) -> dict:
    with open(BENCH_DIR.joinpath(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def reported_e2e(bench: dict, cell: dict) -> list:
    """The end-to-end metrics the cell reports: those without a
    ``workloads`` list and those that list it."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell["name"] in m["workloads"]]


def reported_layers(bench: dict, cell: dict) -> list:
    """The per-layer metrics read in the cell's traced run: those that
    list it, and those without a list whose end-to-end metric it reports."""
    e2e = {m["name"] for m in reported_e2e(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def judge(checks: dict, limits: dict) -> tuple[bool, dict]:
    """{name: {"value", "limit", "ok"}}; a number that is missing, not
    finite or past its limit fails."""
    out, correct = {}, True
    for name, lim in limits.items():
        value = checks.get(name)
        ok = value is not None and math.isfinite(value)
        if ok and "max" in lim:
            ok = value <= lim["max"]
        if ok and "min" in lim:
            ok = value >= lim["min"]
        out[name] = {"value": value, "limit": lim.get("max", lim.get("min")),
                     "bound": "max" if "max" in lim else "min", "ok": ok}
        correct &= ok
    return correct, out


def read_metric(name: str, records: dict):
    """The per-layer reader ``metrics/<name>.py``'s ``read(records)``:
    a number, or None when the run had nothing for it to read."""
    spec = importlib.util.spec_from_file_location(f"vio_bench.metrics.{name}",
                                                  BENCH_DIR / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    value = module.read(records)
    return None if value is None or not math.isfinite(value) else float(value)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    for var, sub in CACHE_ENV.items():
        path = ROOT / ".bench_cache" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def result_line(cell, bench, run: Run, trace: bool, checks_out, correct, device) -> dict:
    metrics = {}
    if not trace:
        for m in reported_e2e(bench, cell):
            metrics[m["name"]] = {"value": run.e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in reported_layers(bench, cell):
            value = read_metric(m["name"], run.records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device.update(busy_s=run.records["busy_s"], window_s=run.records["window_s"])
    line = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device}
    if trace:
        line["breakdown"] = {"device_ops": run.records["device_ops"],
                             "idle_gaps": run.records["idle_gaps"]}
    line["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in checks_out.items()}
    return line


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="python -m vio_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = benchmark()
    cell = find_cell(bench, args.workload)
    cfg = load_json("configs", f"{cell['config']}.json")
    traffic = load_json("traffic", f"{cell['traffic']}.json")
    limits = load_json("limits", f"{cell['name']}.json")

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"vio_bench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch sees {n}", file=sys.stderr)
        return 3
    set_cache_dirs()
    entry = importlib.import_module(f"vio_bench.entries.{traffic['entry']}")
    run = entry.run(cfg, traffic, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), t_start=t_start, device="cuda")

    found = loaded_forbidden()
    if found:
        print(f"vio_bench: the run loaded {found} (JAX or the JAX package)", file=sys.stderr)
        return 4
    correct, checks_out = judge(run.checks, limits["checks"])
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": int(run.memory_peak_bytes)}
    line = result_line(cell, bench, run, bool(args.trace), checks_out, correct, device)
    for note in run.notes:
        print(f"vio_bench: {note}", file=sys.stderr)
    for name in sorted(set(run.checks) - set(checks_out)):
        print(f"vio_bench: reading {name} = {run.checks[name]!r} (not compared)", file=sys.stderr)
    for name, c in checks_out.items():
        print(f"check {name} = {c['value']!r} ({c['bound']} {c['limit']!r}): "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
