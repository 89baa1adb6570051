"""The bytes each fused kernel of the engine step must move, counted
from the step's shapes with every input element read once and every
output element written once (what the work needs, not what a kernel
reads again). Copied from the card checks' bounds (``chip_smoke.py``:
``check_monitor``, ``candidate_bytes``, ``route_bound``)."""
from __future__ import annotations

import numpy as np

LAWS = ("lcmp", "lcmp_w", "ecmp", "ucmp", "wcmp", "redte", "fatpaths", "amp",
        "lcmp_r", "matchrdma")
VIEW_LAWS = ("lcmp", "lcmp_w", "lcmp_r", "fatpaths", "matchrdma")
TREND_LEVELS = 15           # a port's trend threshold row
LEVELS = 16                 # the shared level score table


def monitor_tick_bytes(num_links: int) -> int:
    """One monitor tick over ``num_links`` ports: per port the queue,
    ``queue_cur``, trend, ``dur_cnt`` and its trend threshold row read;
    five registers, ``c_cong`` and one ring slot written; the shared queue
    thresholds and level scores read once."""
    return num_links * (4 + TREND_LEVELS + 7) * 4 + (TREND_LEVELS + LEVELS) * 4


def candidate_bytes(w: dict, pairs: np.ndarray, policy: str, sig_step: int,
                    ring: int) -> int:
    """What ``policy``'s law reads for the candidates of the distinct
    pairs ``pairs``: their candidate rows; each distinct candidate path's
    hop links and the liveness of the links they cross; for the view
    laws each path's signal delays and the distinct ring cells read; per
    path its C_path, capacity or hop count; RedTE's rows; matchrdma's
    link capacity, degrade step and factor. Under ``sweep``, each pair's
    law code and then each law's bytes over its own pairs."""
    if policy == "sweep":
        code = w["pair_policy"][pairs]
        return 4 * pairs.size + sum(
            candidate_bytes(w, pairs[code == c], LAWS[c], sig_step, ring)
            for c in np.unique(code))
    K, H = w["pair_cand"].shape[1], w["path_links"].shape[1]
    nbytes = 4 * K * pairs.size
    cand = np.unique(w["pair_cand"][pairs])
    cand = cand[cand >= 0]
    hops = w["path_links"][cand]
    links = np.unique(hops[hops >= 0])
    nbytes += 4 * H * cand.size + links.size
    if policy in VIEW_LAWS:
        slots = (sig_step - w["path_sig_delay"][cand]) % ring
        cells = np.unique((hops.astype(np.int64) * ring + slots)[hops >= 0])
        nbytes += 4 * H * cand.size + 4 * cells.size
    per_path = {"lcmp": 1, "lcmp_r": 1, "lcmp_w": 2, "ucmp": 1, "wcmp": 1,
                "fatpaths": 1}.get(policy, 0)
    nbytes += 4 * per_path * cand.size
    if policy == "redte":
        nbytes += 4 * K * pairs.size
    if policy == "matchrdma":
        nbytes += 12 * links.size
    return int(nbytes)


def route_arrivals_bytes(w: dict, t: int, policy: str, ring: int,
                         flow_path: np.ndarray) -> int:
    """Routing row ``t`` of the arrivals: the row; each arriving flow's
    pair, id and size; ``candidate_bytes`` of their pairs; the chosen
    paths' links' queues and capacities, each path's delay and rate; 29
    bytes written per routed flow. ``flow_path``: each flow's path after
    the step (a flow keeps its path here: no trip, no re-decision)."""
    row = w["arrivals"][t]
    flows = row[row >= 0]
    nbytes = 4 * row.size + 16 * flows.size
    nbytes += candidate_bytes(w, np.unique(w["f_pair"][flows]), policy, t,
                              ring)
    routed = flows[flow_path[flows] >= 0]
    paths = np.unique(flow_path[routed])
    links = w["path_links"][paths]
    nbytes += 8 * np.unique(links[links >= 0]).size + 8 * paths.size
    return int(nbytes + 29 * routed.size)
