"""The benchmark's data, found by name: ``BENCHMARK.json`` at the checkout's
root names each cell's configuration and traffic mix and each metric; a
configuration's file is where ``BENCHMARK.json`` says, the model family its
``model`` names is ``models/<model>.py``, a traffic mix is
``workloads/<traffic>.json``, a cell's limits ``limits/<cell>.json`` and a
per-layer metric's reader ``metrics/<metric>.py`` beside this package. A
new cell, configuration, model family or metric is taken by adding files and
entries, with no edit to the harness.

A family file provides ``template()``, the program's module on the meta
device, whose state dict names the weights; ``reference(p, x, bn_mode, q)``,
the plain reference's served output, NHWC in [-1, 1], over NHWC x in [0, 1],
with every convolution and matmul operand through ``q`` and its output
through ``q.out`` (as ``reference.Net`` does), so that the controls apply;
``program(weights, device, mix)``, what the cell's entry point is given;
and, where a ``bulk_forward`` cell uses it, ``forward(prog, x_uint8, mix)``,
the served output before the caller quantises it."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]


def _load(name: str, path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Specs:
    def __init__(self, root: Path, bench: Path = BENCH):
        self.root, self.bench = Path(root), Path(bench)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())

    def _entry(self, key: str, name: str) -> dict:
        for e in self.doc[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {key} entry named {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        return json.loads((self.root / self._entry("configs", name)["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "workloads" / f"{name}.json").read_text())

    def limits(self, workload: str) -> Dict[str, float]:
        path = self.bench / "limits" / f"{workload}.json"
        return json.loads(path.read_text())["limits"] if path.exists() else {}

    def end_to_end(self, workload: str) -> List[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.doc["end_to_end"] if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> List[dict]:
        """The per-layer metrics this cell reports: those that list it, and
        those that list no cells and move an end-to-end metric it reports."""
        mine = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.doc["per_layer"]
                if workload in m.get("workloads", [workload] if m["moves"] in mine else [])]

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        """The ``read(data)`` function of ``metrics/<metric>.py``."""
        return _load(f"metric_{metric.replace('.', '_')}", self.bench / "metrics" / f"{metric}.py").read

    def family(self, model: str) -> ModuleType:
        """The model family ``models/<model>.py``, a configuration's
        ``model``."""
        path = self.bench / "models" / f"{model}.py"
        if not path.is_file():
            raise KeyError(f"no model family {model!r}: {path} is missing")
        return _load(f"family_{model.replace('.', '_')}", path)
