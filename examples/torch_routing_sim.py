"""Reproduce the paper's core result on the card: LCMP vs ECMP vs UCMP on
the 8-DC heterogeneous testbed (Fig. 5 direction), the scenario registry's
long-haul mesh and failover, the signal-staleness grid, and the herd
demo on a burst of simultaneous flows (paper challenge C3). The port's
counterpart of ``examples/routing_sim.py``: the same four blocks on the
same specs, each sweep through ``run_sweep`` (one merged world per
static group, the fused CUDA kernels once a step for the whole group).

  PYTHONPATH=src python examples/torch_routing_sim.py               # the card
  PYTHONPATH=src python examples/torch_routing_sim.py --device cpu

Each block is a function of the device (its sweep's specs a function
of their own) and returns what it printed about. The last line gives
the kernel launches of the run (``kernels.ops.counts()``).
"""
import argparse
import json

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core import select
from repro_torch.kernels import ops
from repro_torch.netsim.experiment import ExpSpec
from repro_torch.netsim.sweep import run_sweep

TESTBED_POLICIES = ("ecmp", "ucmp", "lcmp", "lcmp_w")
SCENARIOS = ("longhaul_mesh:routes=6,segs=3", "testbed8_failover:fail_ms=100")
STALENESS = ((0.0, 50_000), (1.0, 50_000), (4.0, 50_000), (1.0, 0))
HERD_FLOWS = 1000
HERD_C_PATH = (10, 12, 15, 200, 220, 250)      # 3 good paths, 3 bad


def testbed_specs() -> list:
    return [ExpSpec(topology="testbed8", load=0.3, policy=pol,
                    duration_us=400_000) for pol in TESTBED_POLICIES]


def scenario_specs() -> list:
    return [ExpSpec(topology=top, load=0.3, policy=pol, duration_us=300_000)
            for top in SCENARIOS for pol in ("lcmp", "ecmp")]


def staleness_specs() -> list:
    # A remote span of the good route silently degrades; the ingress only
    # learns of it one backward propagation delay later (sig_delay_scale
    # scales that delay; 0 = oracle) and its installed C_path table only
    # reprices at the next control-plane refresh (ctrl_period_us; 0 =
    # frozen build-time table). ECMP reads neither signal: its cells are
    # the flat control.
    return [ExpSpec(topology="staleness:deg_ms=60", load=0.5, policy=pol,
                    duration_us=300_000, seed=1,
                    sig_delay_scale=sds, ctrl_period_us=per)
            for sds, per in STALENESS for pol in ("lcmp", "ecmp")]


def testbed_fct(device):
    print("=== FCT slowdown on the 8-DC testbed, WebSearch @30% load ===")
    report = run_sweep(testbed_specs(), device=device)   # one merged world
    for cell in report:
        st = cell.stats
        print(f"  {cell.spec.policy:7s} p50={st.p50:6.2f}  p99={st.p99:7.2f}  "
              f"(completed {st.completed})")
    print(f"  [{report.num_cells} cells in {report.num_groups} merged "
          f"group(s), {report.wall_s:.1f}s]")
    return report


def scenario_registry(device):
    print("\n=== Scenario registry: segmented long-haul mesh + failover ===")
    report = run_sweep(scenario_specs(), device=device)
    for cell in report:
        st = cell.stats
        name = cell.spec.topology.split(":")[0]
        print(f"  {name:18s} {cell.spec.policy:5s} p50={st.p50:6.2f} "
              f"p99={st.p99:7.2f}  completed {st.completed}/{st.offered}")
    return report


def signal_staleness(device):
    print("\n=== Signal staleness (§7.3): how fresh must LCMP's view be? ===")
    report = run_sweep(staleness_specs(), device=device)
    for cell in report:
        s, st = cell.spec, cell.stats
        ctrl = "frozen" if s.ctrl_period_us == 0 else f"{s.ctrl_period_us//1000}ms"
        print(f"  delay x{s.sig_delay_scale:g}  ctrl={ctrl:6s} {s.policy:5s} "
              f"p50={st.p50:6.2f}  p99={st.p99:7.2f}")
    return report


def herd(device) -> np.ndarray:
    """1,000 flows decide at once over 3 good and 3 bad paths: the choice
    histogram (on the host)."""
    print("\n=== Herd mitigation: 1000 flows decide simultaneously ===")
    dev = devmod.resolve(device)
    # uint32 ids i * 2654435761 (mod 2^32), held in int64
    fids = (torch.arange(HERD_FLOWS, dtype=torch.int64, device=dev)
            * 2654435761) & 0xFFFFFFFF
    c_path = torch.tensor(HERD_C_PATH, dtype=torch.int32, device=dev)
    c_cong = torch.zeros(len(HERD_C_PATH), dtype=torch.int32, device=dev)
    valid = torch.ones(len(HERD_C_PATH), dtype=torch.bool, device=dev)
    idx, _ = select.select_egress(fids, c_path, c_cong, valid)
    hist = np.bincount(idx.cpu().numpy(), minlength=len(HERD_C_PATH))
    print("  choice histogram:", hist)
    print("  (greedy min-cost would pile all 1000 onto path 0)")
    return hist


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=devmod.DEFAULT)
    dev = devmod.resolve(ap.parse_args(argv).device)
    ops.reset_counts()
    testbed_fct(dev)
    scenario_registry(dev)
    signal_staleness(dev)
    herd(dev)
    print("kernel launches:", json.dumps(ops.counts()))


if __name__ == "__main__":
    main()
