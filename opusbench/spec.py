"""The benchmark's specification files, found by name.

`BENCHMARK.json` at the root of the checkout lists the cells and the
metrics; each cell is `workloads/<cell>.json` (its configuration, its
traffic mix, the limits of its correctness check and why it exists),
each configuration `configs/<config>.json`, each traffic mix
`traffic/mixes/<traffic>.json`, each decoder adapter
`decoders/<adapter>.py`, each regime `regimes/<regime>.py` and each
metric's reader `metrics/<metric>.py`.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(kind: str, name: str) -> dict:
    """`opusbench/<kind>/<name>.json`, with the name inside it checked."""
    spec = json.loads((HERE / kind / f"{name}.json").read_text())
    if spec.get("name") != name:
        raise ValueError(f"{kind}/{name}.json names itself {spec.get('name')!r}")
    return spec


def load_module(kind: str, name: str):
    """`opusbench/<kind>/<name>.py` as a module (a name may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    mod_name = f"opusbench.{kind}." + name.replace(".", "__")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


class Cell:
    """One cell: its workload file, configuration, traffic mix, and the
    metrics BENCHMARK.json asks of it."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = bench or benchmark()
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"BENCHMARK.json has no workload {name!r}")
        self.name = name
        self.entry = entry
        self.workload = load_json("workloads", name)
        self.config = load_json("configs", entry["config"])
        self.traffic = load_json("traffic/mixes", entry["traffic"])
        for key, want in (("config", entry["config"]), ("traffic", entry["traffic"])):
            if self.workload[key] != want:
                raise ValueError(f"workloads/{name}.json: {key} {self.workload[key]!r}, "
                                 f"BENCHMARK.json says {want!r}")

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]
