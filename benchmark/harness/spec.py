"""What `BENCHMARK.json` and the files it names say, found by name.

A cell (`workloads[]` entry) names a configuration (`configs/<config>.json`),
a traffic mix (`traffic/<traffic>.json`, read by the generator it names,
`traffic/<generator>.py`) and has a file of its own
(`workloads/<cell>.json`: the entry, its parameters, the sample the check
compares and its limits, the profiled stretch). Every metric is a reader in
`metrics/<metric>.py`. Nothing here knows a cell, a configuration or a
metric by name.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]          # benchmark/
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict       # workloads/<cell>.json
    bench: dict

    def metrics(self, kind: str) -> list[dict]:
        """The `end_to_end` or `per_layer` metrics this cell reports."""
        return [m for m in self.bench[kind]
                if "workloads" not in m or self.name in m["workloads"]]

    def generator(self):
        gen = self.traffic["generator"]
        return load_module(HERE / "traffic" / f"{gen}.py", f"bench_traffic_{gen}")

    def entry_module(self):
        name = self.workload["entry"]
        return load_module(HERE / "entries" / f"{name}.py", f"bench_entry_{name}")


def load_cell(name: str) -> Cell:
    bench = _json(ROOT / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    return Cell(name=name, chips=int(w["chips"]),
                config=_json(ROOT / conf["file"]),
                traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
                workload=_json(HERE / "workloads" / f"{name}.json"), bench=bench)


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py", "bench_metric_" + name.replace(".", "_"))


def peaks(kind: str) -> dict | None:
    """The published peaks of a device of this name, or None."""
    return _json(HERE / "harness" / "peaks.json").get(kind)


def program_config(config: dict):
    """The port's `FrameworkConfig` as the configuration file states it:
    every solver and MPC setting of the file given to `default_config`,
    and each one read back. A setting the port has no option for raises."""
    from quadruped_ctrl_tpu_torch.config import default_config

    mpc = dict(config["mpc"])
    dt = float(mpc.pop("dt"))
    over = {"sim.freq": 1.0 / dt}
    for group, values in (("mpc", mpc), ("solver", config["solver"])):
        for k, v in values.items():
            over[f"{group}.{k}"] = tuple(v) if isinstance(v, list) else v
    cfg = default_config(**over)
    for key, v in over.items():
        group, k = key.split(".")
        got = getattr(getattr(cfg, group), k)
        if (list(got) if isinstance(got, tuple) else got) != \
                (list(v) if isinstance(v, tuple) else v):
            raise ValueError(f"the port runs {key} = {got!r}, the configuration states {v!r}")
    if abs(cfg.dt_mpc - dt * int(mpc["iterations_between_mpc"])) > 1e-12:
        raise ValueError(f"the port's dt_mpc {cfg.dt_mpc} differs from the configuration's")
    return cfg
