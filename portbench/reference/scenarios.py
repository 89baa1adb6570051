"""Named scenario registry: topology + event schedules as one unit.

The paper's evaluation (§6) fixes two topologies; related work stresses
regimes neither expresses — FatPaths' failure/non-shortest-path regimes,
MatchRDMA's segmented long-haul OTN links. A *scenario* packages a
topology generator with optional mid-run link-failure and capacity-
degradation schedules plus a designated main traffic pair, addressable
by a single string usable anywhere an ``ExpSpec.topology`` goes::

    ExpSpec(topology="testbed8")                       # paper Fig. 1a
    ExpSpec(topology="longhaul_mesh:routes=8,segs=3")  # parameterized
    ExpSpec(topology="testbed8_failover:fail_ms=120")  # trip link mid-run

Grammar: ``name`` or ``name:key=val,key=val``. Values parse as int,
float, ``a+b+c`` integer tuples, or strings. ``scenarios.names()`` lists
everything registered; unknown names raise with that list (no raw
KeyError escapes to CLI users).

Failure semantics are the paper's lazy data-plane failover: at the trip
step pinned flows re-hash onto live candidates (``fluid._reroute_dead``).
Degradation is *silent*: the link stays up at reduced capacity and only
congestion control + the LCMP congestion registers can react — no
re-route is triggered, which is exactly the regime where cost-aware
placement should beat oblivious hashing.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Optional, Tuple

from . import paths as pathsmod
from . import topo as topomod
from .topo import Topology


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named experiment world: topology + schedules + main pair."""
    name: str
    topology: Topology
    main_pair: Tuple[int, int]
    # ((link_idx, at_us), ...) — hard trips (lazy failover re-hash)
    fail_sched: Tuple[Tuple[int, int], ...] = ()
    # ((link_idx, at_us, factor), ...) — silent capacity loss
    degrade_sched: Tuple[Tuple[int, int, float], ...] = ()
    description: str = ""
    # the advertised traffic endpoints: (src, dst) pairs the path table is
    # built over (None = every node pair). Generators with non-DC helper
    # nodes (wan2000's OTN segment nodes) restrict this to real DC pairs.
    traffic_pairs: Optional[Tuple[Tuple[int, int], ...]] = None
    # candidate-enumeration knobs forwarded to paths.build_path_table —
    # segmented topologies count hops in *links*, so a one-haul detour is
    # `segs` extra hops and the defaults would prune every alternate route
    max_hops: int = pathsmod.MAX_HOPS
    detour_delay: float = 1.5
    detour_hops: int = 1
    # geography metadata (geo family): per-DC coordinates + metro
    # population, indexed by DC node id. traffic/sched.py derives the
    # diurnal timezone phase from dc_lon (longitude/15 deg per hour) and
    # the population-weighted traffic matrix from dc_pop; None for
    # synthetic scenarios (schedules then run unweighted, phase 0).
    dc_lat: Optional[Tuple[float, ...]] = None
    dc_lon: Optional[Tuple[float, ...]] = None
    dc_pop: Optional[Tuple[float, ...]] = None


_REGISTRY: Dict[str, Callable[..., Scenario]] = {}


def register(fn: Callable[..., Scenario]) -> Callable[..., Scenario]:
    _REGISTRY[fn.__name__] = fn
    return fn


def names():
    return sorted(_REGISTRY)


def _parse_value(v: str):
    if re.fullmatch(r"\d+(\+\d+)+", v):      # "200+100+40" -> int tuple
        return tuple(int(x) for x in v.split("+"))
    for cast in (int, float):                # handles "1e+2" etc. as float
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def parse(spec: str):
    """``"name:k=v,k2=v2"`` -> (name, {k: v, k2: v2})."""
    name, _, rest = spec.partition(":")
    params = {}
    for item in filter(None, rest.split(",")):
        k, _, v = item.partition("=")
        if not _ or not k:
            raise ValueError(f"bad scenario parameter {item!r} in {spec!r} "
                             "(expected key=value)")
        params[k] = _parse_value(v)
    return name, params


def get(spec: str) -> Scenario:
    """Resolve a scenario string to a built Scenario."""
    name, params = parse(spec)
    if name not in _REGISTRY:
        raise ValueError(f"unknown scenario {name!r}; "
                         f"available: {', '.join(names())}")
    try:
        return _REGISTRY[name](**params)
    except TypeError as e:
        raise ValueError(f"bad parameters for scenario {name!r}: {e}") from e


def link_index(t: Topology, src: int, dst: int) -> int:
    """Directed link index for (src, dst); raises if absent."""
    for i, (s, d, _, _) in enumerate(t.links):
        if s == src and d == dst:
            return i
    raise ValueError(f"no link {src}->{dst} in {t.name}")


# ------------------------------------------------------------- the registry
@register
def testbed8() -> Scenario:
    """Paper Fig. 1a: 8-DC testbed, six heterogeneous DC1->DC8 routes."""
    return Scenario("testbed8", topomod.testbed_8dc(), main_pair=(0, 7),
                    description=testbed8.__doc__)


@register
def bso13() -> Scenario:
    """Paper §6.2: 13-DC European backbone stand-in (~26% multi-path)."""
    # (0, 6) is a 3-candidate pair (ring both ways + the 0-4 chord)
    return Scenario("bso13", topomod.bso_13dc(), main_pair=(0, 6),
                    description=bso13.__doc__)


@register
def parallel(n: int = 4, cap: int = 100, delay_ms: int = 5) -> Scenario:
    """n identical parallel long-haul routes — the symmetric null case
    where every policy should degenerate to fair hashing."""
    t = topomod.parallel_paths(caps=(cap,) * n,
                               delays_us=(delay_ms * 1000,) * n)
    return Scenario(f"parallel:n={n}", t, main_pair=(0, n + 1),
                    description=parallel.__doc__)


@register
def longhaul_mesh(routes: int = 6, segs: int = 2, caps=(200, 100, 40),
                  lo_ms: int = 5, hi_ms: int = 250) -> Scenario:
    """Parameterized parallel long-haul mesh with *segmented* OTN routes
    (MatchRDMA regime): ``routes`` parallel candidates, each a chain of
    ``segs`` spans; capacities cycle through ``caps`` (pass ``caps=200+100``
    on the CLI) and one-way delays alternate lo_ms / hi_ms per route, so
    every capacity class has a fast and a slow member like the testbed."""
    caps = caps if isinstance(caps, tuple) else (int(caps),)
    route_caps = [caps[i % len(caps)] for i in range(routes)]
    route_delays = [(lo_ms if i % 2 == 0 else hi_ms) * 1000
                    for i in range(routes)]
    t = topomod.segmented_parallel(route_caps, route_delays, segs=segs)
    return Scenario(f"longhaul_mesh:routes={routes},segs={segs}", t,
                    main_pair=(0, 1 + routes * segs),
                    description=longhaul_mesh.__doc__)


@register
def testbed8_failover(fail_ms: int = 100, link: int = 12) -> Scenario:
    """testbed8 with one long-haul link tripped mid-run (default: link 12,
    the DC1->DC5 100G/5ms haul) — drives the lazy fast-failover path."""
    return Scenario(f"testbed8_failover:fail_ms={fail_ms}",
                    topomod.testbed_8dc(), main_pair=(0, 7),
                    fail_sched=((int(link), int(fail_ms) * 1000),),
                    description=testbed8_failover.__doc__)


@register
def bso13_degrade(at_ms: int = 100, factor: float = 0.25) -> Scenario:
    """bso13 with the fat 0<->4 400G chord silently degraded to
    ``factor`` of its capacity in both directions at ``at_ms`` — the
    segmented-OTN partial-failure case where flows stay pinned and only
    congestion-aware placement of *new* flows can route around the loss."""
    t = topomod.bso_13dc()
    at = int(at_ms) * 1000
    sched = ((link_index(t, 0, 4), at, float(factor)),
             (link_index(t, 4, 0), at, float(factor)))
    return Scenario(f"bso13_degrade:at_ms={at_ms}", t, main_pair=(0, 6),
                    degrade_sched=sched,
                    description=bso13_degrade.__doc__)


@register
def staleness(deg_ms: int = 100, factor: float = 0.1,
              src: int = 2, dst: int = 7) -> Scenario:
    """Stale-signal stress family (the §7.3 ablation regime): testbed8
    main pair DC1->DC8, with the *remote* span of its good via-DC3
    candidate route — the DC3->DC8 tail hop, one 25 ms propagation away
    from the DC1 ingress — silently
    degraded to ``factor`` of its 400G at ``deg_ms``. The queue then
    builds a full one-way delay from the decision point, so placement
    quality hinges on how fresh the ingress's congestion view
    (``ExpSpec.sig_delay_scale``) and installed C_path table
    (``ExpSpec.ctrl_period_us``) are; sweep both over this scenario to
    reproduce the staleness ablation grid. (Degrading a *first* hop would
    be invisible to the ablation: the ingress reads its own egress
    registers with zero delay.)"""
    t = topomod.testbed_8dc()
    sched = ((link_index(t, int(src), int(dst)),
              int(deg_ms) * 1000, float(factor)),)
    return Scenario(f"staleness:deg_ms={deg_ms},factor={factor}", t,
                    main_pair=(0, 7), degrade_sched=sched,
                    description=staleness.__doc__)


@register
def wan2000(dcs: int = 20, segs: int = 2, chords: int = 6, seed: int = 0,
            fail_ms: int = 0, deg_ms: int = 0,
            deg_factor: float = 0.25) -> Scenario:
    """Large-scale 2000 km WAN (paper's headline scale claim, MatchRDMA's
    segmented-OTN regime): ``dcs`` DCs (20-64) on a heterogeneous ring +
    ``chords`` shortcut hauls, every haul a chain of ``segs`` OTN spans
    in the 2000 km delay class, and a testbed-style fast-fat/slow-thin
    parallel-haul main pair DC0<->DC1. Advertised traffic pairs are
    exactly the DC pairs with m in [2,8] first-hop-distinct candidates
    (segment nodes are never endpoints), so ``pairs="all"`` +
    ``bg_load`` dose a genuinely multi-path WAN. ``fail_ms``/``deg_ms``
    (optional) trip or silently degrade the fattest main-pair haul's
    first span mid-run — the span-level partial-failure case."""
    w = topomod.wan_2000km(dcs=int(dcs), segs=int(segs), chords=int(chords),
                           seed=int(seed))
    max_hops, ddelay, dhops = 2 * int(segs), 3.0, int(segs)
    dc_pairs = [(s, d) for s in w.dc_nodes for d in w.dc_nodes if s != d]
    # enumerate over ALL DC pairs to find the advertised (multi-path)
    # subset; build_world re-enumerates over just that subset so pair
    # indices stay compact — the throwaway build is numpy-cheap and paid
    # once per topology string (build_world caches)
    table = pathsmod.build_path_table(w.topology, dc_pairs,
                                      max_hops=max_hops, detour_delay=ddelay,
                                      detour_hops=dhops)
    adv = tuple((int(s), int(d)) for s, d, n in
                zip(table.pair_src, table.pair_dst, table.pair_ncand)
                if n >= 2)
    fail_sched: Tuple[Tuple[int, int], ...] = ()
    degrade_sched: Tuple[Tuple[int, int, float], ...] = ()
    li = w.main_haul_links[0]      # fattest main-pair haul, first span
    if int(fail_ms) > 0:
        fail_sched = ((li, int(fail_ms) * 1000),)
    if int(deg_ms) > 0:
        at = int(deg_ms) * 1000
        degrade_sched = ((li, at, float(deg_factor)),
                         (li + 1, at, float(deg_factor)))  # both directions
    return Scenario(f"wan2000:dcs={dcs},segs={segs}", w.topology,
                    main_pair=w.main_pair, fail_sched=fail_sched,
                    degrade_sched=degrade_sched,
                    description=wan2000.__doc__,
                    traffic_pairs=adv, max_hops=max_hops,
                    detour_delay=ddelay, detour_hops=dhops)


@register
def geo(dcs: int = 20, chords: int = 10, seed: int = 0,
        fail_ms: int = 0, deg_ms: int = 0,
        deg_factor: float = 0.25) -> Scenario:
    """Geography-grounded planetary WAN (ROADMAP item 1, MatchRDMA's
    geo-distributed OTN regime): the first ``dcs`` metros of
    ``topo.GEO_DCS`` at their real lat/lon, ring-ordered by longitude,
    every haul's delay derived from geodesic distance at ~0.67c and
    chained from 2000 km-class OTN spans. The main pair is the ring edge
    with the largest population product, carrying three parallel
    fast-fat/slow-thin hauls over progressively longer fiber routes.
    Carries per-DC lat/lon/population metadata so ``ExpSpec.load_sched``
    schedules get real timezone phase shifts and population-weighted
    traffic matrices. ``fail_ms``/``deg_ms`` trip or silently degrade the
    fattest main-pair haul's first span mid-run, as in wan2000."""
    w = topomod.geo_wan(dcs=int(dcs), chords=int(chords), seed=int(seed))
    max_hops = 2 * w.max_spans
    ddelay, dhops = 3.0, 2 * w.max_spans - 1
    dc_pairs = [(s, d) for s in w.dc_nodes for d in w.dc_nodes if s != d]
    # same two-phase enumeration as wan2000: throwaway build over all DC
    # pairs finds the advertised multi-path subset
    table = pathsmod.build_path_table(w.topology, dc_pairs,
                                      max_hops=max_hops, detour_delay=ddelay,
                                      detour_hops=dhops)
    adv = tuple((int(s), int(d)) for s, d, n in
                zip(table.pair_src, table.pair_dst, table.pair_ncand)
                if n >= 2)
    fail_sched: Tuple[Tuple[int, int], ...] = ()
    degrade_sched: Tuple[Tuple[int, int, float], ...] = ()
    li = w.main_haul_links[0]      # fattest main-pair haul, first span
    if int(fail_ms) > 0:
        fail_sched = ((li, int(fail_ms) * 1000),)
    if int(deg_ms) > 0:
        at = int(deg_ms) * 1000
        degrade_sched = ((li, at, float(deg_factor)),
                         (li + 1, at, float(deg_factor)))  # both directions
    return Scenario(f"geo:dcs={dcs},chords={chords},seed={seed}",
                    w.topology, main_pair=w.main_pair,
                    fail_sched=fail_sched, degrade_sched=degrade_sched,
                    description=geo.__doc__, traffic_pairs=adv,
                    max_hops=max_hops, detour_delay=ddelay,
                    detour_hops=dhops, dc_lat=w.dc_lat, dc_lon=w.dc_lon,
                    dc_pop=w.dc_pop)


@register
def jitter(base: str = "testbed8", frac: float = 0.2, seed: int = 0) -> Scenario:
    """Delay-asymmetry jitter over a base scenario's topology: every
    directed link's delay independently scaled by U[1-frac, 1+frac], so
    the two directions of each fiber diverge (asymmetric long-haul RTTs).
    Schedules of the base scenario are preserved."""
    b = get(str(base))
    t = topomod.delay_jitter(b.topology, frac=float(frac), seed=int(seed))
    return Scenario(f"jitter:base={base},frac={frac},seed={seed}", t,
                    main_pair=b.main_pair, fail_sched=b.fail_sched,
                    degrade_sched=b.degrade_sched,
                    description=jitter.__doc__,
                    traffic_pairs=b.traffic_pairs, max_hops=b.max_hops,
                    detour_delay=b.detour_delay, detour_hops=b.detour_hops,
                    dc_lat=b.dc_lat, dc_lon=b.dc_lon, dc_pop=b.dc_pop)
