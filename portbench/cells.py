"""A benchmark cell from its data: the manifest's entry, its
configuration file and its traffic mix, turned into the grid of
``ExpSpec`` field dicts that both the program and the reference run.

Everything is found by name: a cell ``<config>.<traffic>`` in
``BENCHMARK.json`` names its configuration (``configs/<config>.json``)
and traffic mix (``traffic/<traffic>.json``); a per-layer metric
``<name>`` is read by ``metrics/<name>.py``. A later cell, mix,
configuration or metric is new files and a manifest entry.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import itertools
import json
import os
import re
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")
# where configs/, traffic/, metrics/ and limits/ are found (tests point
# it at their own fixtures)
DATA = HERE

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

# the traffic keys the generator reads, and their defaults: ``spec``
# holds further ExpSpec fields for every cell (a re-decision epoch,
# checks, a co-simulated job), ``policy_spec`` fields for one policy's
# cells (amp's subflows)
TRAFFIC_DEFAULTS = {"engine": "fluid", "loads": [0.3], "bg_loads": [0.0],
                    "policies": ["lcmp"], "seeds": 1,
                    "checked_cells": None,
                    "spec": {}, "policy_spec": {}}


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with its files read."""
    name: str
    config: dict
    traffic: dict
    chips: int
    metrics: List[dict]       # the manifest's metrics this cell reports
    end_to_end: List[dict]
    limits: Dict[str, float]  # the compared numbers' limits

    def grid(self, seed: int) -> List[dict]:
        """The cell's grid for ``--seed`` ``seed``: seeds ``k·seed`` ..
        ``k·seed + k - 1`` for ``k = traffic["seeds"]`` (the seeds of two
        runs never overlap), each under every (load, bg_load, policy) of
        the mix, in that nesting."""
        tr = self.traffic
        base = dict(self.config["spec"], engine=tr["engine"], **tr["spec"])
        k = int(tr["seeds"])
        return [dict(base, seed=k * seed + j, load=load, bg_load=bg,
                     policy=pol, **tr["policy_spec"].get(pol, {}))
                for j, load, bg, pol in itertools.product(
                    range(k), tr["loads"], tr["bg_loads"], tr["policies"])]

    def checked(self, seed: int, n_cells: int) -> List[int]:
        """The cells the reference re-runs: all, or ``checked_cells`` of
        them drawn from the seed, spread over the mix's policies."""
        want = self.traffic["checked_cells"]
        if want is None or want >= n_cells:
            return list(range(n_cells))
        import numpy as np
        rng = np.random.default_rng(seed)
        per = len(self.traffic["policies"]) * len(self.traffic["loads"]) * len(
            self.traffic["bg_loads"])
        # one seed's block of cells a pick, so every (load, bg, policy)
        # of the mix is checked once
        blocks = rng.integers(0, n_cells // per, size=per)
        return sorted(int(b) * per + j for j, b in enumerate(blocks))[:want]


def load_manifest(path: Optional[str] = None) -> dict:
    with open(path or MANIFEST) as f:
        return json.load(f)


def _read_json(sub: str, name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = os.path.join(DATA, sub, f"{name}.json")
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, manifest: Optional[dict] = None) -> Cell:
    man = manifest if manifest is not None else load_manifest()
    entry = {w["name"]: w for w in man["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                       f"{[w['name'] for w in man['workloads']]}")
    conf = {c["name"]: c for c in man["configs"]}[entry["config"]]
    config = _read_json("configs", conf["name"])
    limits = _read_json("limits", name)["limits"]
    traffic = dict(TRAFFIC_DEFAULTS, **_read_json("traffic", entry["traffic"]))
    unknown = set(traffic) - set(TRAFFIC_DEFAULTS) - {"why"}
    if unknown:
        raise ValueError(f"traffic {entry['traffic']!r}: unknown keys "
                         f"{sorted(unknown)}")

    def reports(m):
        return name in m.get("workloads", [name])
    return Cell(name=name, config=config, traffic=traffic,
                chips=int(entry["chips"]), limits=limits,
                metrics=[m for m in man["per_layer"] if reports(m)],
                end_to_end=[m for m in man["end_to_end"] if reports(m)])


def metric_reader(name: str):
    """``read(ctx) -> float | None`` of per-layer metric ``name``, from
    ``metrics/<name>.py``."""
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = os.path.join(DATA, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def engine_steps(fields: Dict) -> int:
    """Engine steps (fluid ``dt`` steps or packet slots) of one cell: its
    horizon is twice its traffic's duration, so tail flows finish."""
    from portbench.reference.engine import SimConfig
    return (2 * int(fields["duration_us"])) // SimConfig.dt_us
