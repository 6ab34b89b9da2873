"""``BENCHMARK.json``: checked against the benchmark's contract, and the
lookup of a cell's parts by name.

Everything that belongs to one configuration, traffic mix, driver or
per-layer metric is a file of its own, found by its name:

- a configuration: the ``file`` its entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<traffic>.json``, which names its driver;
- a driver: ``drivers/<driver>.py``, with ``run(ctx) -> Outcome``;
- a per-layer metric: ``metrics/<name>.py``, with ``read(record)``.

So a later change adds a cell, a configuration, a mix or a metric by
adding files and entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # bench_h100/
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


class SpecError(ValueError):
    """``BENCHMARK.json`` breaks the contract."""


def _line(text: Any, what: str) -> None:
    if not isinstance(text, str) or not 1 <= len(text) <= 200 or "\n" in text \
            or "\t" in text or "\r" in text:
        raise SpecError(f"{what}: 1 to 200 characters on one line, no tab: {text!r}")


def _name(text: Any, what: str) -> None:
    if not isinstance(text, str) or not NAME.fullmatch(text):
        raise SpecError(f"{what}: not a name (a letter, digit or _, then up to 63 letters, "
                        f"digits, _, . or -): {text!r}")


def _keys(entry: Dict, required: set, what: str, optional: set = frozenset()) -> None:
    keys = set(entry)
    if not required <= keys or keys - required - optional:
        raise SpecError(f"{what}: keys {sorted(keys)}, expected {sorted(required)}"
                        + (f" and optionally {sorted(optional)}" if optional else ""))


def validate(spec: Dict, root: str) -> None:
    """Raise ``SpecError`` where ``spec`` breaks the contract; ``root`` is
    the checkout the files are looked up in."""
    if set(spec) != TOP_KEYS:
        raise SpecError(f"top-level keys {sorted(spec)}, expected {sorted(TOP_KEYS)}")
    cmd, paths = spec["command"], spec["paths"]
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32):
        raise SpecError("command: a list of 1 to 32 strings")
    for word in cmd:
        _line(word, "command word")
        if word.startswith("/") or ".." in word.split("/"):
            raise SpecError(f"command word leaves the checkout: {word!r}")
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16):
        raise SpecError("paths: a list of 1 to 16 directories")
    for p in paths:
        if not isinstance(p, str) or not PATH.fullmatch(p) or p.startswith("/") \
                or ".." in p.split("/"):
            raise SpecError(f"paths: not a relative path of letters, digits, _ . - /: {p!r}")
    rs = spec["run_seconds"]
    if not (isinstance(rs, int) and not isinstance(rs, bool) and 1 <= rs <= 51):
        raise SpecError(f"run_seconds: a whole number from 1 to 51, got {rs!r}")

    def under_paths(f: str) -> bool:
        return any(f.startswith(p.rstrip("/") + "/") for p in paths)

    seen: set = set()
    configs = {}
    for c in spec["configs"]:
        _keys(c, CONFIG_KEYS, "config")
        _name(c["name"], "config name")
        for k in ("source", "why"):
            _line(c[k], f"config {c['name']} {k}")
        if not under_paths(c["file"]) or not os.path.isfile(os.path.join(root, c["file"])):
            raise SpecError(f"config {c['name']}: file {c['file']!r} is not a file under paths")
        if not isinstance(c["reduced"], list) or len(c["reduced"]) > 16:
            raise SpecError(f"config {c['name']}: reduced is a list of at most 16 keys")
        for k in c["reduced"]:
            _name(k, f"config {c['name']} reduced key")
        if c["name"] in configs or c["file"] in seen:
            raise SpecError(f"config {c['name']}: name or file used twice")
        configs[c["name"]] = c
        seen.add(c["file"])
    if not 1 <= len(configs) <= 24:
        raise SpecError("configs: 1 to 24 entries")

    cells = {}
    pairs = set()
    for w in spec["workloads"]:
        _keys(w, WORKLOAD_KEYS, "workload")
        for k in ("name", "config", "traffic"):
            _name(w[k], f"workload {k}")
        _line(w["why"], f"workload {w['name']} why")
        if w["config"] not in configs:
            raise SpecError(f"workload {w['name']}: no config {w['config']!r}")
        if w["chips"] not in (1, 4) or isinstance(w["chips"], bool):
            raise SpecError(f"workload {w['name']}: chips is 1 or 4")
        if w["name"] in cells or (w["config"], w["traffic"]) in pairs:
            raise SpecError(f"workload {w['name']}: name or (config, traffic) used twice")
        cells[w["name"]] = w
        pairs.add((w["config"], w["traffic"]))
    if not 1 <= len(cells) <= 24:
        raise SpecError("workloads: 1 to 24 entries")
    if sum(w["chips"] == 4 for w in cells.values()) > max(1, len(cells) // 4):
        raise SpecError("at most a quarter of the workloads, or one, take 4 chips")
    if set(configs) - {w["config"] for w in cells.values()}:
        raise SpecError("every config is used by some workload")

    names: set = set()
    for kind, entries, keys, limit in (("end_to_end", spec["end_to_end"], E2E_KEYS, 16),
                                       ("per_layer", spec["per_layer"], LAYER_KEYS, 128)):
        if not 1 <= len(entries) <= limit:
            raise SpecError(f"{kind}: 1 to {limit} metrics")
        for m in entries:
            _keys(m, keys, f"{kind} metric", {"workloads"})
            _name(m["name"], f"{kind} metric name")
            if m["name"] in names:
                raise SpecError(f"metric {m['name']} named twice")
            names.add(m["name"])
            if not isinstance(m["unit"], str) or not UNIT.fullmatch(m["unit"]):
                raise SpecError(f"metric {m['name']}: unit {m['unit']!r} is not 1 to 16 "
                                f"letters, digits, _ / % . -")
            if m["better"] not in ("lower", "higher"):
                raise SpecError(f"metric {m['name']}: better is lower or higher")
            allowed = SOURCES[:1] + SOURCES[3:] if kind == "end_to_end" else SOURCES
            if m["source"] not in allowed:
                raise SpecError(f"metric {m['name']}: source {m['source']!r} not in {allowed}")
            for cell in m.get("workloads", []):
                if cell not in cells:
                    raise SpecError(f"metric {m['name']}: no workload {cell!r}")
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    if "setup_s" not in e2e or "workloads" in e2e["setup_s"]:
        raise SpecError("end_to_end holds setup_s, reported in every cell")
    for m in e2e.values():
        b = m["bound"]
        if not isinstance(b, (int, float)) or isinstance(b, bool) or not 0.01 <= b <= 0.25:
            raise SpecError(f"metric {m['name']}: bound {b!r} not in [0.01, 0.25]")
    for m in spec["per_layer"]:
        _line(m["layer"], f"metric {m['name']} layer")
        if m["moves"] not in e2e:
            raise SpecError(f"metric {m['name']}: moves {m['moves']!r} is no end-to-end metric")
        reporting = cells_reporting(spec, e2e[m["moves"]])
        if set(m.get("workloads", reporting)) - set(reporting):
            raise SpecError(f"metric {m['name']}: a cell in its workloads does not report "
                            f"{m['moves']}")
    for cell in cells:
        reported = [m for m in spec["end_to_end"] if cell in cells_reporting(spec, m)]
        if len(reported) < 2 or not per_layer_of(spec, cell):
            raise SpecError(f"workload {cell}: reports setup_s, another end-to-end metric "
                            f"and a per-layer metric")


def cells_reporting(spec: Dict, metric: Dict) -> List[str]:
    return list(metric.get("workloads", [w["name"] for w in spec["workloads"]]))


def end_to_end_of(spec: Dict, cell: str) -> List[Dict]:
    return [m for m in spec["end_to_end"] if cell in cells_reporting(spec, m)]


def per_layer_of(spec: Dict, cell: str) -> List[Dict]:
    """The per-layer metrics a traced run of ``cell`` reports: those that
    list it, and those without a list whose end-to-end metric it reports."""
    moved = {m["name"] for m in end_to_end_of(spec, cell)}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", []) or ("workloads" not in m and m["moves"] in moved)]


def load(root: str) -> Dict:
    """``BENCHMARK.json`` of the checkout at ``root``, validated."""
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    validate(spec, root)
    return spec


def _module(path: str, name: str) -> ModuleType:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{name}: no file {path}")
    mod_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


class Cell:
    """One workload with its configuration, traffic mix and driver, read
    from their files."""

    def __init__(self, spec: Dict, root: str, name: str, bench_dir: Optional[str] = None):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
        self.bench_dir = bench_dir or HERE
        self.workload = cells[name]
        self.name = name
        entry = next(c for c in spec["configs"] if c["name"] == self.workload["config"])
        with open(os.path.join(root, entry["file"])) as f:
            self.config = json.load(f)
        with open(os.path.join(self.bench_dir, "traffic", self.workload["traffic"] + ".json")) as f:
            self.traffic = json.load(f)
        _name(self.traffic["driver"], "traffic driver")
        self.driver = _module(os.path.join(self.bench_dir, "drivers",
                                           self.traffic["driver"] + ".py"),
                              "bench_driver_" + self.traffic["driver"])
        self.end_to_end = end_to_end_of(spec, name)
        self.per_layer = per_layer_of(spec, name)

    def readers(self) -> Dict[str, ModuleType]:
        """Each per-layer metric of the cell -> its reader module."""
        return {m["name"]: _module(os.path.join(self.bench_dir, "metrics", m["name"] + ".py"),
                                   "bench_metric_" + m["name"].replace(".", "_"))
                for m in self.per_layer}
