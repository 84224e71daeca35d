"""The benchmark's description, found by name: ``BENCHMARK.json`` at the
root of the checkout, the configuration file each cell's configuration
names (and the length table it may name, a path from the root), the
traffic mix ``swbench/traffic/<traffic>.json``, and the reader
``swbench/layers/<metric>.py`` of each per-layer metric."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, entry: dict, root: str = ROOT) -> dict:
    for cfg in bench["configs"]:
        if cfg["name"] == entry["config"]:
            with open(os.path.join(root, cfg["file"])) as f:
                out = json.load(f)
            if "length_table" in out:
                out["length_table"] = os.path.join(root, out["length_table"])
            return out
    raise KeyError(f"no configuration {entry['config']!r} in BENCHMARK.json")


def traffic(entry: dict, root: str = ROOT) -> dict:
    with open(os.path.join(root, "swbench", "traffic", f"{entry['traffic']}.json")) as f:
        return json.load(f)


def metrics(bench: dict, entry: dict, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones:
    those that list it, or list no cells."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if entry["name"] in m.get("workloads", [entry["name"]])]


class _Absent:
    def __repr__(self) -> str:
        return "ABSENT"


# What a reader returns where the program under test has no span, counter
# or kernel of the kind it reads (a parent older than the reader): its
# metric is left out of the line, and the run is judged without it.  None
# says that the reader found nothing where the program should have left
# something.
ABSENT = _Absent()


def reader(name: str):
    """The module that reads per-layer metric ``name`` from a trace, the
    file ``swbench/layers/<name>.py`` (a name may hold dots)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "layers", f"{name}.py")
    found = importlib.util.spec_from_file_location(f"swbench.layers.{name.replace('.', '__')}", path)
    if found is None or not os.path.exists(path):
        raise KeyError(f"no reader {path}")
    module = importlib.util.module_from_spec(found)
    found.loader.exec_module(module)
    return module
