"""The harness: finds a cell and everything that belongs to it by name,
checks the card, hands the cell to its traffic driver, reads the per-layer
metrics, and prints the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. Its own files,
found by name: ``benchmark/workloads/<cell>.json`` (configuration, traffic
kind, the traffic's parameters, the limits of the numbers that decide
``correct``), ``benchmark/configs/<config>.json`` (the configuration as it
is run), ``benchmark/traffic/<kind>.py`` (the driver of that kind of
traffic) and ``benchmark/metrics/<metric>.py`` (one reader per per-layer
metric). Adding a cell, a mix or a metric adds files and entries; no file
here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
# top-level module names that must never be loaded in a benchmark process
FORBIDDEN = ("jax", "jaxlib", "flax", "mla_tpu")
# build and kernel caches, at fixed paths inside the checkout (the program's own
# nvcc builds go to build/mla_tpu_torch/, which it fixes itself)
CACHE_ENV = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
             "CUDA_CACHE_PATH": "nv_compute"}


def set_cache_env() -> None:
    for var, sub in CACHE_ENV.items():
        os.environ[var] = str(ROOT / "build" / "benchmark_cache" / sub)


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(man: dict, name: str) -> dict:
    """The manifest entry of cell ``name`` and its files, read and checked
    against each other."""
    entries = {w["name"]: w for w in man["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(entries)}")
    entry = entries[name]
    cell = load_json(BENCH / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if cell[key] != entry[key]:
            raise ValueError(f"{name}: {key} is {cell[key]!r} in its file, {entry[key]!r} in "
                             "BENCHMARK.json")
    cfg_entry = {c["name"]: c for c in man["configs"]}[entry["config"]]
    config = load_json(ROOT / cfg_entry["file"])
    return {"entry": entry, "cell": cell, "config": config,
            "traffic": BENCH / "traffic" / f"{cell['kind']}.py"}


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(man: dict, name: str) -> Dict[str, List[dict]]:
    """The cell's end-to-end metrics (setup_s and those that list it or
    list no cells) and its per-layer metrics (those that list it, or that
    list no cells and move an end-to-end metric the cell reports)."""
    e2e = [m for m in man["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return {"end_to_end": e2e, "per_layer": per_layer}


def program_config(config: dict):
    """The program's ``Config`` for a configuration file: its preset with its
    overrides, checked against every number the file lists."""
    from mla_tpu_torch.config import get_config

    cfg = get_config(config["preset"], config.get("overrides") or {})
    for block in ("frontend", "model", "data", "train"):
        have = dataclasses.asdict(getattr(cfg, block))
        for key, want in config.get(block, {}).items():
            got = list(have[key]) if isinstance(have[key], tuple) else have[key]
            if got != want:
                raise ValueError(f"configuration {config['name']}: {block}.{key} runs as "
                                 f"{got!r}, the file says {want!r}")
    return cfg


def nearest_rank(values: List[float], q: float) -> float:
    """The q-quantile by nearest rank: the smallest value with at least
    q of the values at or below it."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


@dataclasses.dataclass
class Run:
    """One run of one cell: what its traffic driver needs, and what it
    leaves for the readers and the result line."""

    name: str
    seed: int
    seconds: float
    trace: bool
    device: Any
    cell: dict
    config: dict
    cfg: Any = None  # the program's Config
    t_start: float = dataclasses.field(default_factory=time.perf_counter)
    setup_s: Optional[float] = None
    memory_peak_bytes: int = 0
    counters: Dict[str, Any] = dataclasses.field(default_factory=dict)
    tracer: Any = None
    marks: List[tuple] = dataclasses.field(default_factory=list)

    @property
    def params(self) -> dict:
        return self.cell["params"]

    @property
    def limits(self) -> dict:
        return self.cell["limits"]

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def sync(self):
        if self.on_card:
            import torch

            torch.cuda.synchronize(self.device)

    def mark(self, what: str):
        """Note how far into set-up ``what`` has finished (printed with the
        set-up time)."""
        self.sync()
        self.marks.append((what, round(time.perf_counter() - self.t_start, 3)))

    def setup_done(self):
        """The first timed operation is next: set-up ends here (a traced
        run first starts the device tracing once)."""
        if self.trace:
            self.tracer.warm_up(self.device)
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start
        self.note(f"{self.name}: set-up {self.setup_s:.6f} s; done by then {self.marks}")

    def trace_start_at(self, t0: float) -> float:
        """When, in a window opened at ``t0``, the traced part begins: the
        last ``trace_seconds`` of the window (all of it by default)."""
        return t0 + max(0.0, self.seconds - self.params.get("trace_seconds", self.seconds))

    def maybe_start_trace(self, now: float, t0: float) -> bool:
        """Start the profiler once the traced part of the window opened at
        ``t0`` has begun; True when it starts now."""
        if self.trace and not self.tracer.started and now >= self.trace_start_at(t0):
            self.tracer.start()
            return True
        return False

    def window_closed(self, keep_profiling: bool = False):
        """Close the traced part (and switch the profiler off, unless
        ``keep_profiling``), wait for the card, read the peak memory: what
        follows (drains, the reference) is not part of the window."""
        if self.tracer is not None and self.tracer.started:
            self.tracer.close()
            if not keep_profiling:
                self.tracer.end()
        self.sync()
        if self.on_card:
            import torch

            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated(self.device))

    def note(self, msg: str):
        print(msg, file=sys.stderr, flush=True)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(args, t_start: float) -> int:
    set_cache_env()
    man = manifest()
    files = cell_files(man, args.workload)
    chips = files["entry"]["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() is "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from benchmark.tracing import Tracer

    device = torch.device("cuda", 0)
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats(device)
    run = Run(name=args.workload, seed=args.seed, seconds=float(args.seconds),
              trace=bool(args.trace), device=device, cell=files["cell"],
              config=files["config"], t_start=t_start)
    run.cfg = program_config(run.config)
    run.tracer = Tracer() if run.trace else None
    traffic = load_module(files["traffic"], f"benchmark_traffic_{files['cell']['kind']}")
    out = traffic.run(run)

    wanted = metrics_of(man, args.workload)
    metrics = {}
    if run.trace:
        for m in wanted["per_layer"]:
            reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                                 "benchmark_metric_" + m["name"].replace(".", "_"))
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in wanted["end_to_end"]:
            value = run.setup_s if m["name"] == "setup_s" else out["metrics"].get(m["name"])
            if value is None:
                raise RuntimeError(f"{args.workload}: the traffic gave no {m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    run.note(f"card {power_limit()}")
    bad = forbidden_loaded()
    if bad:
        print(f"the benchmark process loaded {bad}: it may load none of {FORBIDDEN}",
              file=sys.stderr)
        return 3
    checks = out["checks"]
    correct = (out["failed"] == 0 and all(v <= lim for v, lim in checks.values()))
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": chips, "memory_peak_bytes": run.memory_peak_bytes}
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device_info}
    if run.trace:
        s = run.tracer.summary
        device_info["busy_s"] = s["busy_s"]
        device_info["window_s"] = s["window_s"]
        run.note(f"profiler start {run.tracer.start_s} s; traced {s['window_s']:.6f} s")
        line["breakdown"] = {"device_ops": [[k[:120], v] for k, v in s["device_ops"]],
                             "idle_gaps": s["idle_gaps"]}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
