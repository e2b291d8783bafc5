"""The harness's general part: find a cell's files by name, run its
driver, read its per-layer metrics, and form the result line.

A cell is ``workloads/<name>.json`` (``config``, ``traffic``, ``driver``,
``chips``, ``why``, ``limits``); its configuration is
``configs/<config>.json`` and its traffic ``traffic/<traffic>.json``,
both under the data root (this folder by default); its driver is
``drivers/<driver>.py`` and each per-layer metric ``metrics/<metric>.py``
of this folder, whose ``read(record)`` returns a number or None where the
run gave it nothing to read. Nothing here names a cell, a configuration
or a metric: a later cell or metric is a new file.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import torch

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "glint_word2vec_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload with its configuration and traffic, read from files."""

    def __init__(self, name: str, data_root: Optional[Path] = None):
        root = Path(data_root) if data_root is not None else HERE
        path = root / "workloads" / f"{name}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no workload {name!r} ({path})")
        self.name = name
        self.workload = _load_json(path)
        self.config = _load_json(root / "configs" / f"{self.workload['config']}.json")
        self.traffic = _load_json(root / "traffic" / f"{self.workload['traffic']}.json")
        self.chips = int(self.workload.get("chips", 1))
        self.limits: Dict[str, float] = dict(self.workload.get("limits", {}))

    def driver(self):
        kind = self.workload["driver"]
        return _load_module(HERE / "drivers" / f"{kind}.py", f"perfbench_driver_{kind}")


class Context:
    """What a driver is given."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: torch.device, t_start: float, dtype: Optional[str] = None):
        self.cell = cell
        self.config, self.traffic = cell.config, cell.traffic
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = device
        self.t_start = t_start
        #: The tables' storage dtype, where a run asks for another one
        #: than the configuration states (the control).
        self.dtype = dtype or cell.config["dtype"]
        #: Seconds since ``t_start`` at the end of each set-up stage.
        self.stages: Dict[str, float] = {}

    def stage(self, name: str) -> None:
        """Mark the end of a set-up stage (logged with the window)."""
        self.stages[name] = round(time.time() - self.t_start, 3)

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def readers() -> dict:
    """Every per-layer metric reader, by metric name."""
    out = {}
    for path in sorted((HERE / "metrics").glob("*.py")):
        name = path.name[:-3]
        if name.startswith("_"):
            continue
        out[name] = _load_module(path, "perfbench_metric_" + name.replace(".", "_"))
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_block(device: torch.device, chips: int, peak: int,
                 trace_summary: Optional[dict]) -> dict:
    if device.type == "cuda":
        block = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                 "count": chips, "memory_peak_bytes": int(peak)}
    else:
        block = {"platform": "cpu", "kind": "cpu", "count": 1,
                 "memory_peak_bytes": int(peak)}
    if trace_summary is not None and trace_summary.get("busy_s"):
        block["busy_s"] = trace_summary["busy_s"]
        block["window_s"] = trace_summary["window_s"]
    return block


def _window_summary(record: dict) -> dict:
    """The record's scalars, and the quartiles and extremes of its lists."""
    from perfbench import yardstick

    out = {}
    for k, v in record.items():
        if isinstance(v, (int, float, str)):
            out[k] = v
        elif isinstance(v, list) and v and isinstance(v[0], (int, float)):
            out[k] = {"n": len(v), "min": min(v), "median": yardstick.median(v),
                      "p95": yardstick.percentile(v, 95), "max": max(v)}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: Optional[float] = None,
             dtype: Optional[str] = None) -> dict:
    """Run one cell and return its result line as a dict, ``checks``
    last."""
    ctx = Context(cell, seed, seconds, trace, device,
                  time.time() if t_start is None else t_start, dtype)
    out = cell.driver().run(ctx)
    checks = out["checks"]
    metrics = {}
    if trace:
        rec = out["record"]
        for name, mod in readers().items():
            value = mod.read(rec)
            if value is not None:
                metrics[name] = {"value": value, "unit": mod.UNIT}
    else:
        for name, (value, unit) in out["end_to_end"].items():
            metrics[name] = {"value": value, "unit": unit}
    line = {
        "correct": bool(checks.correct and out["failed"] == 0),
        "attempted": int(out["attempted"]),
        "failed": int(out["failed"]),
        "metrics": metrics,
        "device": device_block(device, cell.chips, out["memory_peak_bytes"],
                               out.get("trace")),
    }
    tr = out.get("trace")
    if trace and tr is not None and tr.get("device_ops"):
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = checks.as_line()
    log("set-up stages (s since start): " + json.dumps(ctx.stages))
    log("window: " + json.dumps(_window_summary(out["record"])))
    for text in checks.lines():
        log(text)
    return line


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return res.stdout.strip() or res.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
