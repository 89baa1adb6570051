"""Inter-DC topologies used in the paper's evaluation (§6, Fig. 4).

A topology is a small directed graph of DCI switches: ``links[i] =
(src, dst, cap_gbps, delay_us)``. Intra-DC fabrics are abstracted away —
the paper provisions them (100G leaf-spine, 400G DCI uplinks) precisely
so they are never the bottleneck; all placement dynamics happen on the
inter-DC links, which is what we model.

Provided:
- ``testbed_8dc``    : Fig. 1a / §6.1 — DC1..DC8, six candidate routes
  DC1->DC8 through DC2..DC7 with {200,200,100,100,40,40} Gbps long-haul
  links, one low-delay (5 ms) and one high-delay (250 ms) member per
  capacity class, and fat 400 Gbps / 1 ms tail hops so the long-haul link
  defines each path.
- ``bso_13dc``       : §6.2 — a 13-DC European backbone in the style of
  BSONetworkSolutions (Internet Topology Zoo). The Zoo's exact edge list
  is not redistributable offline, so we build a structurally matched
  stand-in: 13 nodes, sparse ring+chord mesh, delays quantized to
  {1, 5, 10} ms (200/1000/2000 km) and heterogeneous 40-400 Gbps
  capacities, tuned so ~26% of node pairs see multiple first-hop-distinct
  candidate routes (paper: 20/78 = 25.6%).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

Link = Tuple[int, int, int, int]  # (src, dst, cap_gbps, delay_us)


@dataclasses.dataclass(frozen=True)
class Topology:
    name: str
    num_nodes: int
    links: List[Link]              # directed (both directions listed)

    @property
    def num_links(self) -> int:
        return len(self.links)

    def arrays(self):
        a = np.asarray(self.links, np.int64)
        return (a[:, 0].astype(np.int32), a[:, 1].astype(np.int32),
                a[:, 2].astype(np.int32), a[:, 3].astype(np.int32))


def _bidir(edges: List[Link]) -> List[Link]:
    out: List[Link] = []
    for s, d, c, dl in edges:
        out.append((s, d, c, dl))
        out.append((d, s, c, dl))
    return out


def testbed_8dc() -> Topology:
    """Fig. 1a. Nodes 0..7 = DC1..DC8. Six 2-hop routes DC1->DC8."""
    ms = 1000
    # (transit DC, long-haul capacity Gbps, long-haul one-way delay us)
    # Delays span the paper's stated 5-250 ms range with one low-delay and
    # one high-delay member per capacity class. The intermediate values
    # (25/35 ms) matter: they put the 4th-cheapest path within beta*255
    # fused-cost points of the kept set, so the congestion term can swap a
    # hot low-delay path out — the adaptivity the paper's ablation
    # (rm-beta "fails for large transfers") demonstrates. All-extreme
    # delays (5 vs 250 only) would make the kept set static under (3,1).
    classes = [
        (1, 200, 250 * ms),   # DC2: high-capacity, high-delay
        (2, 200, 25 * ms),    # DC3: high-capacity, low-delay
        (3, 100, 35 * ms),    # DC4: medium, higher-delay
        (4, 100, 5 * ms),     # DC5: medium, low-delay
        (5, 40, 5 * ms),      # DC6: low, low-delay
        (6, 40, 250 * ms),    # DC7: low, high-delay
    ]
    edges: List[Link] = []
    for dc, cap, delay in classes:
        edges.append((0, dc, cap, delay))      # DC1 -> transit (long haul)
        edges.append((dc, 7, 400, 1 * ms))     # transit -> DC8 (fat tail hop)
    return Topology("testbed-8dc", 8, _bidir(edges))


def bso_13dc() -> Topology:
    """13-DC European backbone stand-in (BSONetworkSolutions style).

    Delay tiers: 1 ms (~200 km), 5 ms (~1000 km), 10 ms (~2000 km).
    Mixed 40-400 Gbps provisioning; sparse enough that only a quarter of
    pairs are truly multi-path (paper §6.2: gains dilute system-wide).
    """
    ms = 1000
    edges: List[Link] = [
        # core western-European ring
        (0, 1, 200, 1 * ms), (1, 2, 200, 1 * ms), (2, 3, 100, 5 * ms),
        (3, 4, 100, 1 * ms), (4, 5, 200, 5 * ms), (5, 6, 100, 1 * ms),
        (6, 7, 100, 5 * ms), (7, 8, 40, 1 * ms), (8, 9, 100, 5 * ms),
        (9, 10, 200, 1 * ms), (10, 11, 40, 5 * ms), (11, 12, 100, 1 * ms),
        (12, 0, 200, 10 * ms),
        # long-haul chords (2000 km class) creating multi-path pairs;
        # this set yields 26.3% multi-path pairs (paper: 20/78 = 25.6%)
        (0, 4, 400, 10 * ms), (2, 6, 40, 10 * ms), (5, 12, 100, 10 * ms),
    ]
    return Topology("bso-13dc", 13, _bidir(edges))


def duplex_line(num_nodes: int = 3, cap: int = 100, delay_us: int = 5000) -> Topology:
    """Tiny chain for unit tests."""
    edges = [(i, i + 1, cap, delay_us) for i in range(num_nodes - 1)]
    return Topology("line", num_nodes, _bidir(edges))


def segmented_parallel(route_caps, route_delays_us, segs: int = 2,
                       tail_cap: int = 400, tail_delay_us: int = 1000) -> Topology:
    """Parallel long-haul routes where each route's long haul is a chain of
    ``segs`` OTN segments in series (MatchRDMA-style segmented links: a
    2000 km haul is really several amplified/regenerated spans, and a
    single span can fail or degrade independently).

    Node layout: 0 = src DC, then ``segs`` transit nodes per route, then
    dst = 1 + len(routes)*segs. Route i gets capacity ``route_caps[i]`` on
    every segment and its one-way delay ``route_delays_us[i]`` split evenly
    across segments, followed by a fat tail hop into the destination (the
    same "long haul defines the path" construction as the 8-DC testbed).

    With the default ``MAX_HOPS=5`` path enumeration, ``segs`` must stay
    <= 4 (segs long-haul hops + 1 tail hop per route).
    """
    n = len(route_caps)
    assert len(route_delays_us) == n
    if not 1 <= segs <= 4:   # paths.MAX_HOPS=5 minus the tail hop
        raise ValueError(f"segs={segs} unroutable: paths are segs+1 hops "
                         "and candidate enumeration caps at 5 (paths.MAX_HOPS)")
    dst = 1 + n * segs
    edges: List[Link] = []
    for i, (cap, delay) in enumerate(zip(route_caps, route_delays_us)):
        seg_delay = max(int(delay) // segs, 1)
        nodes = [0] + [1 + i * segs + j for j in range(segs)]
        for a, b in zip(nodes[:-1], nodes[1:]):
            edges.append((a, b, int(cap), seg_delay))
        edges.append((nodes[-1], dst, tail_cap, tail_delay_us))
    return Topology(f"segmented-parallel-{n}x{segs}", dst + 1, _bidir(edges))


# ------------------------------------------------- large-scale 2000 km WAN
# Declared hardware classes for the wan_2000km generator; the generator
# invariants test asserts every emitted link against these.
WAN_CAP_CLASSES = (400, 200, 100, 40)           # Gbps per haul
WAN_DELAY_CLASSES_US = (8_000, 10_000, 12_000)  # one-way per ~2000 km haul


@dataclasses.dataclass(frozen=True)
class WanWorld:
    """A generated WAN plus the metadata the scenario layer needs."""
    topology: Topology
    main_pair: Tuple[int, int]
    dc_nodes: Tuple[int, ...]        # traffic endpoints (segment nodes excluded)
    main_haul_links: Tuple[int, ...]  # first directed link of each main-pair
    #                                   parallel haul, fattest first


def wan_2000km(dcs: int = 20, segs: int = 2, chords: int = 6,
               seed: int = 0) -> WanWorld:
    """Large-scale heterogeneous 2000 km-class WAN (the paper's headline
    "large-scale NS-3 simulations under the 2000 km inter-DC scenario",
    stretched into MatchRDMA's segmented-OTN regime).

    Structure: ``dcs`` DC nodes on a ring of long-haul fiber hauls, plus
    ``chords`` random shortcut hauls and two extra *parallel* hauls on
    the DC0<->DC1 edge (so the designated main pair has a fast-fat /
    medium / slow-thin candidate mix like the 8-DC testbed). Every haul
    is ~2000 km: one-way delay from ``WAN_DELAY_CLASSES_US``, capacity
    from ``WAN_CAP_CLASSES``, and each haul is a chain of ``segs``
    amplified/regenerated OTN segments (dedicated intermediate nodes) so
    a single span can fail or degrade independently.

    Deterministic under ``(dcs, segs, chords, seed)``. DC nodes are
    0..dcs-1; segment nodes follow. Paths between DCs are chains of
    whole hauls, so candidate enumeration needs ``max_hops = 2 * segs``
    (two hauls) and a detour budget of one extra haul — the scenario
    layer passes those via ``Scenario.max_hops``/``detour_*``.
    """
    if dcs < 4:
        raise ValueError(f"wan_2000km needs dcs >= 4, got {dcs}")
    if segs < 1:
        raise ValueError(f"wan_2000km needs segs >= 1, got {segs}")
    rng = np.random.default_rng(seed)
    # hauls as DC-level edges: (a, b, cap_gbps, one_way_delay_us)
    hauls: List[Link] = []
    # the main pair's three parallel hauls, fattest first (testbed-style
    # heterogeneity: fast-fat / medium / slow-thin)
    main = [(0, 1, 200, WAN_DELAY_CLASSES_US[0]),
            (0, 1, 100, WAN_DELAY_CLASSES_US[1]),
            (0, 1, 40, WAN_DELAY_CLASSES_US[2])]
    hauls += main
    for i in range(1, dcs):   # rest of the ring (edge 0-1 is covered above)
        cap = int(rng.choice(WAN_CAP_CLASSES))
        dl = int(rng.choice(WAN_DELAY_CLASSES_US))
        hauls.append((i, (i + 1) % dcs, cap, dl))
    seen = {(a, b) for a, b, _, _ in hauls}
    tries = 0
    placed = 0
    while placed < chords and tries < 20 * chords:
        tries += 1
        a = int(rng.integers(0, dcs))
        off = int(rng.choice([2, 3, max(dcs // 2, 4)]))
        b = (a + off) % dcs
        if a == b or (a, b) in seen or (b, a) in seen:
            continue
        seen.add((a, b))
        hauls.append((a, b, int(rng.choice(WAN_CAP_CLASSES)),
                      int(rng.choice(WAN_DELAY_CLASSES_US))))
        placed += 1
    if placed < chords:
        # never return a sparser WAN than the scenario string advertises —
        # downstream claims (advertised-pair counts, multipath fraction)
        # would silently describe a different topology
        raise ValueError(
            f"wan_2000km(dcs={dcs}) could only place {placed} of {chords} "
            "requested chords (distinct {2,3,dcs/2}-offset slots exhausted); "
            "lower chords= or raise dcs=")

    # expand each haul into `segs` spans through dedicated segment nodes;
    # _bidir emits (fwd, rev) per span, so a haul's first directed link
    # (the one schedules target) is at index 2 * (its first span's row)
    edges: List[Link] = []
    next_node = dcs
    main_first: List[int] = []
    for h, (a, b, cap, dl) in enumerate(hauls):
        seg_delay = max(dl // segs, 1)
        nodes = [a] + [next_node + j for j in range(segs - 1)] + [b]
        next_node += segs - 1
        if h < len(main):
            main_first.append(2 * len(edges))
        for u, v in zip(nodes[:-1], nodes[1:]):
            edges.append((u, v, cap, seg_delay))
    t = Topology(f"wan-2000km-{dcs}dc-{segs}seg-s{seed}", next_node,
                 _bidir(edges))
    return WanWorld(topology=t, main_pair=(0, 1),
                    dc_nodes=tuple(range(dcs)),
                    main_haul_links=tuple(main_first))


# --------------------------------------------- geography-grounded WAN (geo)
# Great-circle math + a planetary DC ring: the wan_2000km generator with
# *declared* delay classes replaced by delays derived from real DC-metro
# coordinates at fiber propagation speed. Long-haul fiber carries light at
# ~0.67c (group index ~1.47), i.e. ~0.2009 km/us — the constant every WAN
# RTT rule-of-thumb (~1 ms per 100 km one-way) comes from.
EARTH_RADIUS_KM = 6371.0
FIBER_KM_PER_US = 0.299792458 * 0.67          # ~0.2009 km/us at 0.67c
GEO_SPAN_KM = 2000.0                          # OTN span class (wan2000's)
# fiber routes are never great circles: declared route-stretch factors,
# one per parallel main-pair haul (fat haul gets the direct route, the
# thin ones progressively longer detour fibers — the testbed's
# fast-fat/slow-thin heterogeneity, now geographically motivated) and one
# for every ordinary ring/chord haul.
GEO_MAIN_STRETCH = (1.0, 1.25, 1.5)
GEO_RING_STRETCH = 1.1
GEO_MAIN_CAPS = (200, 100, 40)                # Gbps, fattest first

# DC metros: (name, lat, lon, metro population in millions). geo_wan
# selects the first ``dcs`` entries, then ring-orders them by longitude
# (the natural planetary ring). Populations drive the traffic-matrix
# weights (traffic/sched.py), coordinates drive haul delays and the
# diurnal timezone phase (longitude / 15 deg per hour).
GEO_DCS = (
    ("tokyo", 35.6762, 139.6503, 37.0),
    ("delhi", 28.7041, 77.1025, 32.0),
    ("shanghai", 31.2304, 121.4737, 28.0),
    ("saopaulo", -23.5505, -46.6333, 22.0),
    ("mexicocity", 19.4326, -99.1332, 22.0),
    ("dhaka", 23.8103, 90.4125, 22.0),
    ("cairo", 30.0444, 31.2357, 21.0),
    ("beijing", 39.9042, 116.4074, 21.0),
    ("mumbai", 19.0760, 72.8777, 21.0),
    ("osaka", 34.6937, 135.5023, 19.0),
    ("newyork", 40.7128, -74.0060, 19.0),
    ("karachi", 24.8607, 67.0011, 16.0),
    ("buenosaires", -34.6037, -58.3816, 15.0),
    ("istanbul", 41.0082, 28.9784, 15.0),
    ("lagos", 6.5244, 3.3792, 15.0),
    ("london", 51.5074, -0.1278, 14.0),
    ("losangeles", 34.0522, -118.2437, 13.0),
    ("paris", 48.8566, 2.3522, 11.0),
    ("johannesburg", -26.2041, 28.0473, 6.0),
    ("singapore", 1.3521, 103.8198, 6.0),
    ("sydney", -33.8688, 151.2093, 5.0),
    ("seattle", 47.6062, -122.3321, 4.0),
    ("frankfurt", 50.1109, 8.6821, 2.7),
    ("dublin", 53.3498, -6.2603, 1.4),
)


def geodesic_km(lat1, lon1, lat2, lon2):
    """Haversine great-circle distance in km (scalars or numpy arrays)."""
    la1, lo1, la2, lo2 = (np.radians(np.asarray(x, np.float64))
                          for x in (lat1, lon1, lat2, lon2))
    h = (np.sin((la2 - la1) / 2.0) ** 2
         + np.cos(la1) * np.cos(la2) * np.sin((lo2 - lo1) / 2.0) ** 2)
    return 2.0 * EARTH_RADIUS_KM * np.arcsin(np.sqrt(np.clip(h, 0.0, 1.0)))


def fiber_delay_us(dist_km: float, stretch: float = 1.0) -> int:
    """One-way propagation delay of a fiber route ``stretch`` x the
    geodesic, at ~0.67c. Floors at 1 us (metro-adjacent DCs)."""
    return max(int(round(dist_km * stretch / FIBER_KM_PER_US)), 1)


def geo_spans(dist_km: float, stretch: float = 1.0,
              max_spans: int = 4) -> int:
    """Number of 2000 km-class OTN spans a haul of this route length is
    chained from (amplifier/regenerator sites), capped so candidate
    enumeration hop budgets stay bounded — a capped haul just has
    longer-than-class spans."""
    return int(np.clip(np.ceil(dist_km * stretch / GEO_SPAN_KM),
                       1, max_spans))


@dataclasses.dataclass(frozen=True)
class GeoWorld:
    """A geography-grounded WAN plus the metadata the scenario and
    traffic-schedule layers need (same role as WanWorld, with
    coordinates/populations attached)."""
    topology: Topology
    main_pair: Tuple[int, int]
    dc_nodes: Tuple[int, ...]
    main_haul_links: Tuple[int, ...]  # first directed link per main haul
    dc_name: Tuple[str, ...]
    dc_lat: Tuple[float, ...]
    dc_lon: Tuple[float, ...]
    dc_pop: Tuple[float, ...]        # millions (traffic-matrix weights)
    max_spans: int                   # per-haul span cap (hop budgets)


def geo_wan(dcs: int = 20, chords: int = 10, seed: int = 0,
            max_spans: int = 4) -> GeoWorld:
    """Planetary WAN grounded in real geography: the first ``dcs``
    entries of ``GEO_DCS`` ring-ordered by longitude, ring hauls between
    longitude neighbors plus ``chords`` random shortcut hauls, every haul
    delay derived from the geodesic distance at ~0.67c (``stretch`` x
    for fiber-route detour) and chained from 2000 km-class OTN spans
    (``geo_spans``). The main pair is the ring edge with the largest
    population product, given three parallel hauls (200/100/40 Gbps at
    progressively longer fiber routes — fast-fat/slow-thin). Capacities
    still come from ``WAN_CAP_CLASSES``; *delays* are geography.

    Deterministic under ``(dcs, chords, seed)``.
    """
    if not 4 <= dcs <= len(GEO_DCS):
        raise ValueError(f"geo_wan needs 4 <= dcs <= {len(GEO_DCS)}, "
                         f"got {dcs}")
    sel = sorted(GEO_DCS[:dcs], key=lambda c: c[2])   # ring by longitude
    names = tuple(c[0] for c in sel)
    lat = tuple(float(c[1]) for c in sel)
    lon = tuple(float(c[2]) for c in sel)
    pop = tuple(float(c[3]) for c in sel)

    def dist(a: int, b: int) -> float:
        return float(geodesic_km(lat[a], lon[a], lat[b], lon[b]))

    # main pair: the ring edge with the largest population product
    ring = [(i, (i + 1) % dcs) for i in range(dcs)]
    ma, mb = max(ring, key=lambda e: pop[e[0]] * pop[e[1]])

    rng = np.random.default_rng(seed)
    # hauls: (a, b, cap_gbps, one_way_delay_us, spans)
    hauls = []
    d_main = dist(ma, mb)
    for cap, stretch in zip(GEO_MAIN_CAPS, GEO_MAIN_STRETCH):
        hauls.append((ma, mb, cap, fiber_delay_us(d_main, stretch),
                      geo_spans(d_main, stretch, max_spans)))
    for a, b in ring:
        if (a, b) == (ma, mb):
            continue
        d = dist(a, b)
        hauls.append((a, b, int(rng.choice(WAN_CAP_CLASSES)),
                      fiber_delay_us(d, GEO_RING_STRETCH),
                      geo_spans(d, GEO_RING_STRETCH, max_spans)))
    seen = {(a, b) for a, b, *_ in hauls}
    placed, tries = 0, 0
    while placed < chords and tries < 20 * chords:
        tries += 1
        a = int(rng.integers(0, dcs))
        off = int(rng.choice([2, 3, max(dcs // 2, 4)]))
        b = (a + off) % dcs
        if a == b or (a, b) in seen or (b, a) in seen:
            continue
        seen.add((a, b))
        d = dist(a, b)
        hauls.append((a, b, int(rng.choice(WAN_CAP_CLASSES)),
                      fiber_delay_us(d, GEO_RING_STRETCH),
                      geo_spans(d, GEO_RING_STRETCH, max_spans)))
        placed += 1
    if placed < chords:
        raise ValueError(
            f"geo_wan(dcs={dcs}) could only place {placed} of {chords} "
            "requested chords; lower chords= or raise dcs=")

    # expand hauls into spans through dedicated segment nodes (the
    # wan_2000km construction: a haul's first directed link index is
    # 2 * its first span's row, _bidir interleaves fwd/rev)
    edges: List[Link] = []
    next_node = dcs
    main_first: List[int] = []
    for h, (a, b, cap, dl, segs) in enumerate(hauls):
        seg_delay = max(dl // segs, 1)
        nodes = [a] + [next_node + j for j in range(segs - 1)] + [b]
        next_node += segs - 1
        if h < len(GEO_MAIN_CAPS):
            main_first.append(2 * len(edges))
        for u, v in zip(nodes[:-1], nodes[1:]):
            edges.append((u, v, cap, seg_delay))
    t = Topology(f"geo-{dcs}dc-s{seed}", next_node, _bidir(edges))
    return GeoWorld(topology=t, main_pair=(ma, mb),
                    dc_nodes=tuple(range(dcs)),
                    main_haul_links=tuple(main_first),
                    dc_name=names, dc_lat=lat, dc_lon=lon, dc_pop=pop,
                    max_spans=max_spans)


def delay_jitter(base: Topology, frac: float = 0.2, seed: int = 0) -> Topology:
    """Apply asymmetric delay jitter: every *directed* link's propagation
    delay is independently scaled by U[1-frac, 1+frac], so forward and
    reverse directions of the same fiber diverge — the delay-asymmetry
    regime long-haul RTT estimators (and the paper's delayScore) must
    tolerate."""
    rng = np.random.default_rng(seed)
    links = [(s, d, c, max(int(round(dl * (1.0 + frac * (2.0 * rng.random() - 1.0)))), 1))
             for (s, d, c, dl) in base.links]
    return Topology(f"{base.name}-jitter{frac}s{seed}", base.num_nodes, links)


def parallel_paths(caps=(100, 100), delays_us=(5000, 5000)) -> Topology:
    """src=0, dst=N+1, one transit node per parallel path — the minimal
    multi-path fixture for routing tests."""
    edges: List[Link] = []
    n = len(caps)
    for i, (c, d) in enumerate(zip(caps, delays_us)):
        edges.append((0, 1 + i, c, d))
        edges.append((1 + i, n + 1, 400, 1000))
    return Topology("parallel", n + 2, _bidir(edges))
