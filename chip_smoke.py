#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a card and the CUDA
toolkit: ``python3 chip_smoke.py``. It prints one JSON object per phase
and, last, ``{"ok": true, "device": {...}}``. Any failed check raises, so
the script exits non-zero and prints no result line. Phases:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: the three CUDA sources compiled for sm_90a from
   ``src/repro_torch/kernels/csrc`` (one nvcc each, in parallel), with
   ptxas registers and spills;
3. lint: the port's reprolint (``python -m repro_torch.analysis
   --format=json``) over the checkout must be clean (exit 0), its file
   and suppressed counts printed; then its DEV family held against the
   card (``examples/torch_decode_sync.py``'s check): ``decode_step`` of
   qwen3-4b (4 layers) and falcon-mamba-7b (2 layers) at full width in
   bf16, batch 4, runs steps 1-8 under
   ``torch.cuda.set_sync_debug_mode("error")`` after a first step, its
   logits finite; a step that synchronizes fails the phase and names its
   lines of the port beside whether the static lint names them too (the
   engines' steps are held this way in phase sanitize); and rope's
   ``theta``, gemma's embedding scale and an int position, now filled on
   the card, equal the host-built tensors bit for bit;
4. kernel_check: each kernel entry against its plain PyTorch version
   on the card, bit for bit, at the main path's shapes (testbed8 and
   wan2000, and geo's 8-hop paths) and at bulk shapes, with CUDA-event
   times, host time per call and byte bounds. The fused ``monitor_tick``
   and ``route_arrivals`` (every law of ``LAWS``) run from random states
   (dead links, a degrade schedule, negative ring offsets, all-pad rows,
   flow 0 among pads, the congestion fallback) and must leave every flow
   they do not route untouched; ``decide`` (every law) decides all of
   wan2000's flows and 2^20 bulk flows (dead links, the fallback, the
   failover's ring step -1, salted keys), its first kernel's table of
   per-pair records held against ``decide_records_ref`` and its two
   kernels also timed apart; both also with a random law
   per pair (the sweep's ``pair_policy``) on the merged world of the
   fig5 group and at the bulk shape; a ``lcmp_decide`` call with 9
   candidates must raise on the card;
5. run: the runs of ``ALONE`` through ``run_experiment`` (fig5's
   testbed8 lcmp, ecmp, wcmp and matchrdma, fig10's CC laws,
   fig_multipath's fluid rows but the re-decision cells of phase sweep):
   FCT slowdown and completion against ``REFERENCE`` within the bands,
   wall time, peak memory and the kernels' launch counts, which must show one
   ``monitor_tick`` and one ``route_arrivals`` launch a step, one
   ``decide`` launch per trip step and re-decision epoch, no standalone
   entry and no plain version; the other runs of ``RUNS`` are cells of
   phase sweep's groups;
6. packet: the runs of ``PACKET_ALONE`` (the packet engine on
   fidelity_bench's testbed8 lcmp cell, the full-size wan2000, the
   failover with go-back-N, fig_multipath's packet rows with the flowlet plane
   armed) the same way against ``PACKET_REFERENCE``: one
   ``monitor_tick`` and one ``route_arrivals`` launch a slot, one
   ``decide`` per trip step and per slot while the flowlet plane is
   armed; hop queues non-negative and inside the buffer (its testbed8
   ecmp cell runs in phase packet_sweep's grid);
7. profile: where a testbed8 lcmp fluid step's and a packet slot's time
   goes (torch.profiler): wall and device-busy time per step, idle
   share, kernels per step, the two fused kernels' and ``index_add_``'s
   device time;
8. sweep: each group of ``SWEEPS`` (fig5's whole 15-cell grid, the
   wan2000 pair, the failover pair, the re-decision rows) through
   ``run_sweep`` as one merged world: one ``monitor_tick`` and one
   ``route_arrivals`` launch a step for the whole group, ``decide`` per
   trip step and epoch, no plain version; each cell against its
   reference number within the bands, and each cell that phase run ran
   alone against that run to the printed digits; the batched wall time
   beside phase run's times for those cells, peak memory; then the
   profile of a merged fig5 step; every run of ``RUNS`` driven alone or
   as a cell, and the reference's ``ORDERINGS`` on their numbers;
9. sweep_mesh: ``run_sweep(use_mesh=True)``'s runner
   (``sweep.run_sharded``) on ``[cuda:0, cuda:0]``: the groups of
   ``MESH_GROUPS`` (fig5 split 8 + 7, staleness_epoch 2 + 1), each shard
   a merged world in one of two worker processes sharing the card; every
   cell's final state equal to phase sweep's merged run of it bit for
   bit; the workers' launches, added to this process's counts, one
   ``monitor_tick`` and one ``route_arrivals`` a step per shard and each
   shard's own ``decide``s; a plain version raises in a worker; each
   worker's start-up and peak memory, the sharded wall beside the
   merged one;
10. packet_sweep: fidelity_bench's grid (2 scenarios x 3 policies x both
   engines, 12 cells in 4 groups) through one ``run_sweep`` at its
   default and quick scales: the launch counts per group, each cell
   against its reference number (``PACKET_REFERENCE``,
   ``FIDELITY_REFERENCE``) and the cells phase packet ran alone against
   those runs; the log-space Pearson r of packet against fluid against
   the reference's (the paper's 0.95 bar is reached at the
   quick scale only, as in the reference); LCMP below ECMP on testbed8
   under both engines; every run of ``PACKET_RUNS`` driven alone or as a
   cell, and the reference's ``PACKET_ORDERINGS`` on their numbers;
11. sanitize: the physics-invariant sanitizer at tests/test_sanitize.py's
   spec (testbed8, load 0.7, 40 ms) on both engines: a checked run's
   final state equals a checks-off run's bit for bit; neither makes a
   host sync inside its step loop after the set-up step 0
   (``torch.cuda.set_sync_debug_mode("error")``), and a checked run reads
   its checks once, at its end; every seeded bug of
   ``tests/torch_mutations.py`` fires under its own name on both
   engines, ``signal_causality`` through a negated ``path_sig_delay``
   and ``pfc_lossless`` through a patched ``pfc_gate`` (packet,
   ``pairs="all"``, a 2e5-byte buffer); each seeded bug corrupts every
   step from step 0, so its run stops at ``MUTATION_STEPS``;
12. cosim: fig_training's design point (the degraded wan2000 at load
   0.7, bg_load 0.15, seed 9, 400 ms, qwen3-4b and gemma2-9b x ecmp,
   wcmp, fatpaths, matchrdma, lcmp x both engines: 20 cells, two merged
   groups) through ``run_sweep``: one ``monitor_tick`` and one
   ``route_arrivals`` launch a step per group and no ``decide``; each
   cell's strict iteration p50 and p99 against ``COSIM_REFERENCE`` (3%,
   10%; infinite in both or neither), iterations done equal, completions
   within 1% of offered; the LCMP ordering flag of each (engine, model)
   equal to the reference's;
13. switch: the switch object model (``core.switchd``: 48 ports, 8
   candidates, a 65,536-slot flow cache) over 200 ticks of random queues
   and 4,096 arrivals (half established), a port death at tick 100 and
   GC every 50 ticks, through the standalone ``cong_update`` and
   ``lcmp_decide`` entries; choices, new-flow flags, registers and the
   whole cache equal to the same run through the plain versions on the
   card, bit for bit; a colliding batch's cache equal to the CPU's;
   more than 8 candidates refused;
14. device_vs_cpu: 50 ms of testbed8 lcmp, testbed8_failover lcmp (a
   trip at 25 ms), a 3-cell sweep group, and the packet engine's testbed8 lcmp
   and failover runs on the card and on the CPU (plain versions) must
   route the same flows the same way;
15. train: the multi-pod LCMP train step at qwen3-4b's full width (depth
   cut to 4 layers, one 4096-token sequence per pod, 2 pods on the card):
   3 steps with the int8 wire, then 1 f32-wire step from the state after
   step 2; the int8 gradient against the exact pod mean block by block,
   the route binding and wire bytes, the qsr launches, the two paths'
   parameters against AdamW's bound; time split, tokens/s, peak memory;
16. train_device_vs_cpu: one smoke-size 2-pod int8 step on the card
   and on the CPU from the same weights and batch;
17. dist: the pod reduce across processes, 2 ranks on the one card over
   Gloo, each one pod (``PodGroup``): each rank's own 1.18 G-element
   vector reduced over the group with the int8 and f32 wires, every
   rank's result against the one-process ``PodAxis`` reduce on the card
   bit for bit (exact digests) and its route bytes against the
   reference's loop; then one int8 train step of phase train's cell on
   each rank as its pod: the ranks' parameters equal bit for bit, losses
   and norm within rtol 1e-3 of phase train's first step; the wall time
   of each wire leg, each rank's qsr launches and peak memory (the
   FSDP x TP step on a DeviceMesh is not run on the card: DTensor's
   collectives over Gloo crash for ranks sharing one card);
18. families: every configuration at its published widths in bf16,
   depth cut where ``FAMILY_LAYERS`` says (qwen3-4b, gemma2-9b, glm4-9b,
   mistral-nemo-12b, mixtral-8x7b, dbrx-132b cut; falcon-mamba-7b,
   zamba2-1.2b, whisper-medium and internvl2-2b at full depth), each on
   64 random tokens, teacher-forced ``decode_step`` logits against
   ``forward``'s at rtol = atol = 2e-2 (the reference's oracle): the moe
   forward with one-token dispatch groups as decode has them, no token
   dropped by either pass; whisper's forward on its frames against a
   decode from the cross cache ``prefill_cross_cache`` makes of the
   encoder's output; internvl2's decode (no patch prefix, as the
   reference's) against the dense-family forward of the same parameters,
   and its forward with patches finite; the two mamba configurations'
   oracle in float32 on the same weights (``ORACLE_F32``; their bf16
   distances recorded); gemma2-9b (2 layers: one local, one global) on a
   4160-token prompt, its last 64 decode positions past the 4096-token
   window against ``forward``;
   ``local_block_attention`` against windowed ``gqa_attention`` at
   gemma2's shapes (S = 12288); the hybrid gradient: one zamba2-1.2b
   train step at full width (1 layer) on 4096 tokens, its loss finite
   and its non-finite gradient leaves the reference's
   (``HYBRID_NONFINITE``: the reference's ``mamba2_ssd`` overflow,
   reproduced);
19. serve: ``launch.serve.prefill_then_decode`` at the reference's
   defaults (batch 4, prompt 32, gen 32) for qwen3-4b, gemma2-9b,
   mixtral-8x7b, falcon-mamba-7b, zamba2-1.2b and internvl2-2b:
   tokens/s, ms per decode step, peak memory;
20. launch_train: the training launcher's loop at full width on one
   4096-token sequence, 3 steps of gemma2-9b (4 layers), mixtral-8x7b
   (1 layer), falcon-mamba-7b (1 layer) and whisper-medium (full
   depth, its frames in the batch): finite losses, step time, tokens/s,
   peak memory; then its checkpoints at the smoke size of qwen3-4b,
   falcon-mamba-7b and whisper-medium: bit-exact restores, resume from
   step 2 to 4, the resumed step-3 loss, a SIGTERM's emergency
   checkpoint (zamba2 is not trained: its gradient is NaN, as the
   reference's);
21. dryrun: the multi-pod dry run (``launch.dryrun``) on fake CUDA
   tensors over fake process groups: (a) qwen3-4b train_4k, prefill_32k
   and decode_32k and falcon-mamba-7b long_500k on the (16, 16) mesh and
   qwen3-4b train_4k on (2, 16, 16), each through the CLI in a
   subprocess of its own (all at once, ``run_cells``, the CLI's
   ``--jobs``), at depths 2 and 3 extrapolated
   to the full depth: every record ``ok``, the backward included, its
   roofline terms at H100 constants beside the card's name and power
   limit; (b) phase train's cell (qwen3-4b at 4 layers, one 4096-token
   sequence) as the sharded step on a 1 x 1 mesh, once with real tensors
   on the card under the dry run's counter and once through
   ``lower_cell`` on fake tensors: FLOPs equal, the dry run's peak
   within ``DRYRUN_MEM_BAND`` of the real step's
   ``max_memory_allocated`` increase, the step time and the share of
   989 TFLOP/s it reaches;
then the ``kernels`` summary line and the result line. Phase 4 also
holds ``qsr_int8`` and ``qsr_dequant`` against their plain versions, bit
for bit, at 1024, 2^16 and 2^24 elements and at the train phase's two
wire-leg sizes, and times the standalone ``cong_update`` and
``lcmp_decide`` entries first at the shapes phase switch launches them
at (48 ports; 4,096 flows x 8 candidates).
"""
from __future__ import annotations

import collections
import dataclasses
import inspect
import itertools
import json
import math
import os
import signal
import subprocess
import sys
import time
import warnings
from types import SimpleNamespace

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM HBM rate (NVIDIA data sheet). Both kernels do a few integer
# operations per byte they move, far below the card's balance of
# operations to bytes, so their bound is the bytes they must move.
PEAK_BYTES_PER_S = 3.35e12

TESTBED8 = dict(topology="testbed8", load=0.5, duration_us=400_000)
WAN2000 = dict(topology="wan2000:dcs=24,segs=2,chords=12", pairs="main",
               load=0.5, bg_load=0.25, cap_scale=0.0625, duration_us=400_000)
WORLDS = {"testbed8": TESTBED8, "wan2000": WAN2000}
# the kernel checks also take geo, whose paths have the most hops (H = 8)
GEO = dict(topology="geo", load=0.5, duration_us=100_000)
CHECK_WORLDS = {**WORLDS, "geo": GEO}
# the other cells: fig10's CC laws (benchmarks/figures.py fig10), the
# failover, and the fluid rows of fig_multipath (a degraded remote span
# under a twice-stale signal plane; the degraded 2000 km WAN)
FIG10 = dict(topology="testbed8", load=0.3, duration_us=400_000)
FAILOVER = dict(topology="testbed8_failover:fail_ms=133", load=0.3,
                duration_us=400_000)
STALENESS = dict(topology="staleness:deg_ms=80", load=0.4, seed=1,
                 sig_delay_scale=2.0, duration_us=400_000)
WAN_DEG = dict(topology="wan2000:dcs=24,segs=2,chords=12,deg_ms=133,"
               "deg_factor=0.25", pairs="main", load=0.5, bg_load=0.15, seed=9,
               cap_scale=0.0625, duration_us=400_000)
EPOCH = dict(redecide_period_us=10_000)      # fig_multipath's re-decision
# every run of phase 5: name -> ExpSpec fields
RUNS = {
    "testbed8/lcmp": dict(TESTBED8, policy="lcmp"),
    "testbed8/ecmp": dict(TESTBED8, policy="ecmp"),
    "wan2000/lcmp": dict(WAN2000, policy="lcmp"),
    "wan2000/ecmp": dict(WAN2000, policy="ecmp"),
    # the rest of fig5's row (benchmarks/figures.py fig5_testbed_fct)
    "testbed8/ucmp": dict(TESTBED8, policy="ucmp"),
    "testbed8/redte": dict(TESTBED8, policy="redte"),
    "testbed8/lcmp_w": dict(TESTBED8, policy="lcmp_w"),
    "testbed8/wcmp": dict(TESTBED8, policy="wcmp"),
    "testbed8/matchrdma": dict(TESTBED8, policy="matchrdma"),
    "fig10/lcmp/dctcp": dict(FIG10, policy="lcmp", cc="dctcp"),
    "fig10/lcmp/timely": dict(FIG10, policy="lcmp", cc="timely"),
    "fig10/lcmp/hpcc": dict(FIG10, policy="lcmp", cc="hpcc"),
    "failover/lcmp": dict(FAILOVER, policy="lcmp"),
    "failover/ecmp": dict(FAILOVER, policy="ecmp"),
    "staleness/fatpaths": dict(STALENESS, policy="fatpaths", **EPOCH),
    "staleness/lcmp_r": dict(STALENESS, policy="lcmp_r", **EPOCH),
    "staleness/amp": dict(STALENESS, policy="amp", n_subflows=4),
    "wan2000_deg/lcmp": dict(WAN_DEG, policy="lcmp"),
    "wan2000_deg/fatpaths": dict(WAN_DEG, policy="fatpaths", **EPOCH),
}
# the JAX package's results on the same specs (p50, p99, completed,
# offered), computed on the CPU and pinned by
# tests/test_torch_fluid_runs.py; the port must land within the bands
REFERENCE = {"testbed8/lcmp": (13.27, 87.80, 3124, 3134),
             "testbed8/ecmp": (5.89, 112.58, 3134, 3134),
             "wan2000/lcmp": (2.115, 17.44, 16743, 16745),
             "wan2000/ecmp": (3.491, 52.41, 16737, 16745),
             "testbed8/ucmp": (41.82, 50.00, 3134, 3134),
             "testbed8/redte": (4.908, 46.74, 3133, 3134),
             "testbed8/lcmp_w": (6.578, 21.11, 3134, 3134),
             "testbed8/wcmp": (5.973, 42.94, 3134, 3134),
             "testbed8/matchrdma": (6.020, 43.76, 3134, 3134),
             "fig10/lcmp/dctcp": (2.823, 5.148, 1870, 1870),
             "fig10/lcmp/timely": (4.162, 14.23, 1869, 1870),
             "fig10/lcmp/hpcc": (2.883, 6.439, 1870, 1870),
             "failover/lcmp": (4.362, 26.24, 1867, 1870),
             "failover/ecmp": (5.996, 48.44, 1870, 1870),
             "staleness/fatpaths": (6.037, 44.37, 2578, 2578),
             "staleness/lcmp_r": (6.019, 45.62, 2578, 2578),
             "staleness/amp": (48.78, 88.07, 2577, 2578),
             "wan2000_deg/lcmp": (1.111, 5.294, 10335, 10337),
             "wan2000_deg/fatpaths": (1.131, 14.77, 10337, 10337)}
# phase sweep: each group one static group of run_sweep, a list of
# ExpSpec fields. fig5 is the figure's whole grid at its default scale
# (benchmarks/figures.py fig5_testbed_fct: 3 loads x 5 policies); the
# others are the wan2000 pair, the failover pair and fig_multipath's
# testbed re-decision rows with lcmp beside them
FIG5_POLICIES = ("ecmp", "ucmp", "redte", "lcmp", "lcmp_w")
SWEEPS = {
    "fig5": [dict(TESTBED8, load=load, policy=p) for load in (0.3, 0.5, 0.8)
             for p in FIG5_POLICIES],
    "wan2000": [dict(WAN2000, policy=p) for p in ("lcmp", "ecmp")],
    "failover": [dict(FAILOVER, policy=p) for p in ("lcmp", "ecmp")],
    "staleness_epoch": [dict(STALENESS, policy=p, **EPOCH)
                        for p in ("fatpaths", "lcmp_r", "lcmp")],
}
# phase sweep_mesh: these groups of SWEEPS split over MESH_WORKERS worker
# processes sharing the card, each cell's final state held to phase
# sweep's merged run of it (the fields of a sweep cell's final view)
MESH_GROUPS = ("fig5", "staleness_epoch")
MESH_WORKERS = 2
SWEEP_FINAL = ("done", "fct_us", "flow_path", "serv_bytes", "c_path",
               "route_nonce")
# the JAX package's run_sweep on the sweep cells that no run of RUNS
# covers (p50, p99, completed, offered), computed on the CPU and pinned by
# tests/test_torch_sweep_reference.py; the other cells take REFERENCE's
SWEEP_REFERENCE = {"fig5/0.3/ecmp": (4.362, 43.53, 1870, 1870),
                   "fig5/0.3/ucmp": (11.15, 42.26, 1870, 1870),
                   "fig5/0.3/redte": (4.407, 42.38, 1870, 1870),
                   "fig5/0.3/lcmp": (4.172, 14.30, 1869, 1870),
                   "fig5/0.3/lcmp_w": (4.340, 7.830, 1870, 1870),
                   "fig5/0.8/ecmp": (13.86, 243.7, 5003, 5016),
                   "fig5/0.8/ucmp": (63.57, 83.62, 5016, 5016),
                   "fig5/0.8/redte": (8.475, 176.0, 5014, 5016),
                   "fig5/0.8/lcmp": (39.51, 200.9, 4986, 5016),
                   "fig5/0.8/lcmp_w": (16.67, 83.07, 5007, 5016),
                   "staleness_epoch/lcmp": (6.182, 47.70, 2576, 2578)}
# orderings of the reference that each pair of runs must keep (a, b, stat):
# stat of run a below run b's
ORDERINGS = [("testbed8/lcmp", "testbed8/ecmp", "p99"),
             ("wan2000/lcmp", "wan2000/ecmp", "p50"),
             ("wan2000/lcmp", "wan2000/ecmp", "p99"),
             ("failover/lcmp", "failover/ecmp", "p99"),
             ("wan2000_deg/lcmp", "wan2000_deg/fatpaths", "p99")]
# phase packet: the packet engine (netsim/packet.py) through run_experiment,
# 400 ms of arrivals each: fidelity_bench's testbed8 cell
# (benchmarks/figures.py fidelity_bench), the full-size wan2000 run, the
# failover (go-back-N at the trip) and fig_multipath's packet rows, which
# arm both re-decision knobs (benchmarks/figures.py fig_multipath) so that
# the packet engine's flowlet plane runs
PACKET_TESTBED8 = dict(topology="testbed8", load=0.3, seed=1,
                       duration_us=400_000, engine="packet")
FLOWLET = dict(flowlet_gap_us=1000, redecide_period_us=10_000)
PACKET_RUNS = {
    "packet/testbed8/lcmp": dict(PACKET_TESTBED8, policy="lcmp"),
    "packet/testbed8/ecmp": dict(PACKET_TESTBED8, policy="ecmp"),
    "packet/wan2000/lcmp": dict(WAN2000, engine="packet", policy="lcmp"),
    "packet/wan2000/ecmp": dict(WAN2000, engine="packet", policy="ecmp"),
    "packet/failover/lcmp": dict(FAILOVER, engine="packet", policy="lcmp"),
    "packet/staleness/fatpaths": dict(STALENESS, engine="packet",
                                      policy="fatpaths", **FLOWLET),
    "packet/staleness/amp": dict(STALENESS, engine="packet", policy="amp",
                                 n_subflows=4),
}
# the JAX package's results on the same specs (p50, p99, completed,
# offered), computed on the CPU and pinned by
# tests/test_torch_packet_reference.py
PACKET_REFERENCE = {"packet/testbed8/lcmp": (1.367, 8.185, 1918, 1918),
                    "packet/testbed8/ecmp": (5.893, 42.25, 1918, 1918),
                    "packet/wan2000/lcmp": (1.013, 2.438, 16744, 16745),
                    "packet/wan2000/ecmp": (1.118, 6.251, 16743, 16745),
                    "packet/failover/lcmp": (4.334, 15.60, 1869, 1870),
                    "packet/staleness/fatpaths": (5.991, 58.38, 2578, 2578),
                    "packet/staleness/amp": (41.74, 43.21, 2578, 2578)}
# the runs that phases run and packet drive alone through run_experiment.
# The others are cells of a group of SWEEPS or of the fidelity grid, which
# drive them through run_sweep and hold them to the same reference numbers;
# testbed8/lcmp, testbed8/ecmp and packet/testbed8/lcmp run both ways, so
# that a merged cell is held to its run alone on the card
ALONE = ("testbed8/lcmp", "testbed8/ecmp", "testbed8/wcmp",
         "testbed8/matchrdma", "fig10/lcmp/dctcp", "fig10/lcmp/timely",
         "fig10/lcmp/hpcc", "staleness/amp", "wan2000_deg/lcmp",
         "wan2000_deg/fatpaths")
PACKET_ALONE = ("packet/testbed8/lcmp", "packet/wan2000/lcmp",
                "packet/wan2000/ecmp", "packet/failover/lcmp",
                "packet/staleness/fatpaths", "packet/staleness/amp")
PACKET_ORDERINGS = [("packet/testbed8/lcmp", "packet/testbed8/ecmp", "p50"),
                    ("packet/testbed8/lcmp", "packet/testbed8/ecmp", "p99"),
                    ("packet/wan2000/lcmp", "packet/wan2000/ecmp", "p50"),
                    ("packet/wan2000/lcmp", "packet/wan2000/ecmp", "p99")]
# phase packet_sweep: fidelity_bench's whole grid (benchmarks/figures.py
# fidelity_bench): 2 scenarios x 3 policies x both engines, seed 1, at its
# default scale (400 ms, the remote degrade at 80 ms) and at its quick
# scale (300 ms, at 60 ms), where the reference reaches the paper's bar;
# run_sweep makes one group per scenario and engine
FIDELITY_DURATION = {"fidelity": 400_000, "fidelity_quick": 300_000}
FIDELITY_LOADS = {"testbed8": 0.3, "staleness": 0.4}
FIDELITY_POLICIES = ("ecmp", "ucmp", "lcmp")
# the JAX package's run_sweep on the grids' cells that no run of
# PACKET_RUNS covers (p50, p99, completed, offered), pinned by
# tests/test_torch_fidelity_reference.py, with each grid's log-space Pearson
# r of packet against fluid over the (cell, p50/p99) points
FIDELITY_REFERENCE = {
    "fidelity/testbed8/ecmp/fluid": (5.988, 41.97, 1917, 1918),
    "fidelity/testbed8/ucmp/fluid": (20.93, 41.90, 1918, 1918),
    "fidelity/testbed8/ucmp/packet": (4.372, 41.86, 1918, 1918),
    "fidelity/testbed8/lcmp/fluid": (4.312, 15.06, 1917, 1918),
    "fidelity/staleness/ecmp/fluid": (6.377, 78.23, 2578, 2578),
    "fidelity/staleness/ecmp/packet": (5.991, 58.38, 2578, 2578),
    "fidelity/staleness/ucmp/fluid": (42.53, 64.34, 2574, 2578),
    "fidelity/staleness/ucmp/packet": (41.84, 99.33, 2578, 2578),
    "fidelity/staleness/lcmp/fluid": (6.122, 43.41, 2576, 2578),
    "fidelity/staleness/lcmp/packet": (3.246, 12.26, 2578, 2578),
    "fidelity_quick/testbed8/ecmp/fluid": (4.352, 41.93, 1422, 1422),
    "fidelity_quick/testbed8/ecmp/packet": (4.351, 42.09, 1422, 1422),
    "fidelity_quick/testbed8/ucmp/fluid": (4.600, 42.29, 1422, 1422),
    "fidelity_quick/testbed8/ucmp/packet": (4.355, 41.91, 1422, 1422),
    "fidelity_quick/testbed8/lcmp/fluid": (1.424, 7.282, 1422, 1422),
    "fidelity_quick/testbed8/lcmp/packet": (1.031, 4.391, 1422, 1422),
    "fidelity_quick/staleness/ecmp/fluid": (6.612, 42.30, 1917, 1918),
    "fidelity_quick/staleness/ecmp/packet": (6.008, 42.38, 1917, 1918),
    "fidelity_quick/staleness/ucmp/fluid": (41.84, 64.34, 1910, 1918),
    "fidelity_quick/staleness/ucmp/packet": (41.83, 78.73, 1918, 1918),
    "fidelity_quick/staleness/lcmp/fluid": (6.106, 25.95, 1918, 1918),
    "fidelity_quick/staleness/lcmp/packet": (1.661, 13.04, 1917, 1918)}
FIDELITY_PEARSON = {"fidelity": 0.8983, "fidelity_quick": 0.9631}
# r moves with the 24 numbers it correlates, each held to its band; the
# paper's testbed-vs-NS-3 bar, which the reference reaches at the quick
# scale only
PEARSON_BAND, PAPER_PEARSON = 0.02, 0.95
# phase sanitize: tests/test_sanitize.py's spec (396 flows, 400 steps); a
# seeded bug corrupts the state at every step, so its run is cut to the
# first MUTATION_STEPS steps
SANITIZE = dict(topology="testbed8", load=0.7, duration_us=40_000)
MUTATION_STEPS = 100
# phase device_vs_cpu: the length of each run on the card and on the CPU
DEVICE_VS_CPU_US = 50_000
# phase cosim: fig_training's design point at its default scale
# (benchmarks/figures.py fig_training: the degraded wan2000, bg_load 0.15,
# both models, all five policies, both engines; the figure's other 60
# cells, at bg_load 0.1 or on the healthy haul, are not run here)
COSIM = dict(topology="wan2000:dcs=8,segs=2,chords=4,deg_ms=133,"
             "deg_factor=0.1", load=0.7, bg_load=0.15, seed=9, pairs="main",
             cap_scale=0.0625, duration_us=400_000, cosim_iters=6)
COSIM_MODELS = ("qwen3-4b", "gemma2-9b")
COSIM_POLICIES = ("ecmp", "wcmp", "fatpaths", "matchrdma", "lcmp")
# the JAX package's run_sweep on those cells (strict iteration p50 and p99
# in ms, iterations done of 6, completed, offered), computed on the CPU and
# pinned by tests/test_torch_cosim_reference.py, with each (engine, model)'s
# LCMP ordering flag (lcmp at or below every baseline in both
# percentiles, lcmp's completions above COMPLETION_FLOOR): False in all
# four in the reference itself
COSIM_REFERENCE = {
    "cosim/fluid/qwen3-4b/ecmp": (206.3, 362.2, 6, 3620, 3626),
    "cosim/fluid/qwen3-4b/wcmp": (393.3, 504.0, 6, 3619, 3626),
    "cosim/fluid/qwen3-4b/fatpaths": (206.3, 362.2, 6, 3620, 3626),
    "cosim/fluid/qwen3-4b/matchrdma": (81.79, 711.9, 6, 3622, 3626),
    "cosim/fluid/qwen3-4b/lcmp": (98.20, 368.6, 6, 3621, 3626),
    "cosim/fluid/gemma2-9b/ecmp": (242.3, 380.5, 6, 3656, 3662),
    "cosim/fluid/gemma2-9b/wcmp": (390.4, 503.6, 6, 3655, 3662),
    "cosim/fluid/gemma2-9b/fatpaths": (242.3, 380.5, 6, 3656, 3662),
    "cosim/fluid/gemma2-9b/matchrdma": (88.23, 696.6, 6, 3658, 3662),
    "cosim/fluid/gemma2-9b/lcmp": (107.1, 264.9, 6, 3657, 3662),
    "cosim/packet/qwen3-4b/ecmp": (76.73, 397.8, 6, 3625, 3626),
    "cosim/packet/qwen3-4b/wcmp": (430.9, 630.9, 6, 3626, 3626),
    "cosim/packet/qwen3-4b/fatpaths": (76.73, 397.8, 6, 3625, 3626),
    "cosim/packet/qwen3-4b/matchrdma": (59.73, 93.07, 6, 3626, 3626),
    "cosim/packet/qwen3-4b/lcmp": (73.73, 305.1, 6, 3626, 3626),
    "cosim/packet/gemma2-9b/ecmp": (264.9, 406.3, 6, 3661, 3662),
    "cosim/packet/gemma2-9b/wcmp": (431.9, 631.9, 6, 3662, 3662),
    "cosim/packet/gemma2-9b/fatpaths": (264.9, 406.3, 6, 3661, 3662),
    "cosim/packet/gemma2-9b/matchrdma": (59.73, 92.67, 6, 3662, 3662),
    "cosim/packet/gemma2-9b/lcmp": (61.40, 307.5, 6, 3662, 3662)}
COSIM_ORDERING = {("fluid", "qwen3-4b"): False, ("fluid", "gemma2-9b"): False,
                  ("packet", "qwen3-4b"): False,
                  ("packet", "gemma2-9b"): False}
# benchmarks/figures.py COMPLETION_FLOOR, copied
COMPLETION_FLOOR = 0.99
# phase switch: paper §4's storage-budget switch (48 ports,
# tests/test_core_switch.py) with 8 candidates and a 65,536-slot cache;
# ticks 100 us apart, GC every 50 ticks at a 2 ms idle timeout
SWITCH = dict(ports=48, cands=8, capacity=1 << 16, ticks=200, batch=4096,
              dead_tick=100, gc_every=50, idle_timeout_us=2_000, seed=18)
# every law of the port's route and decide entries (engine.POLICY_CODES
# but the sweep), and the laws that read the delayed congestion view
LAWS = ("lcmp", "lcmp_w", "ecmp", "ucmp", "wcmp", "redte", "fatpaths", "amp",
        "lcmp_r", "matchrdma")
VIEW_LAWS = ("lcmp", "lcmp_w", "lcmp_r", "fatpaths", "matchrdma")
P50_BAND, P99_BAND, COMPLETED_BAND = 0.03, 0.10, 0.01
BULK = 1 << 20
# the route's bulk shape: 4096 arrival slots over 2^20 links
ROUTE_BULK = dict(A=4096, T=4, L=BULK, NPAIR=4096, K=8, NP=1 << 16, H=8,
                  ring=16, F=BULK)
# the per-flow fields the route writes
FLOW_FIELDS = ("flow_path", "remaining", "rate", "cc_target", "active",
               "extra_wait", "rtt_steps", "route_step")
HASH_EDGES = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
# decide's two kernels, timed apart
STAGE_MS = ("pairs_ms", "pick_ms")

# The train phase: qwen3-4b (configs/qwen3_4b.py) at full width, with the
# depth cut from 36 layers to 4 and train_4k's global batch of 256
# sequences cut to one 4096-token sequence per pod, so that two pods'
# gradients, the AdamW state and the int8 wire fit one card.
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_PODS = 4, 4096, 2
DIST_RANKS, DIST_SEED = 2, 21        # phase dist: ranks on one card, pod seeds
# After one step from the same state the int8 wire's noise moves a
# parameter beyond float32 rounding only where the noise is comparable to
# its gradient: 1.5% of elements at the train size on the H100, 5.9% at
# the smoke size on the CPU. A wire that misplaces blocks, drops a pod or
# scales one block in 7 wrongly moves 45-84% of them at the smoke size
# (tests/test_torch_train.py, test_chip_smoke_train_checks_catch_a_broken_wire).
FAR_SHARE = 0.10
# bytes an element the qsr kernels must move: quant reads 4 B of x and
# 4 B of bits and writes 1 B of q; dequant reads 1 B and writes 4 B;
# each adds a 4-byte scale per 1024 elements
QSR_BYTES = {"qsr_int8": 9, "qsr_dequant": 5}


# Phases families, serve and launch_train: the attention decoders at
# their published widths, depth cut to fit one card (PERF.md section 4);
# family checks run one 64-token sequence (batch 1, so a moe forward's
# tokens are not regrouped), serve the reference's launcher defaults
FAMILY_LAYERS = {"qwen3_4b": 4, "gemma2_9b": 4, "glm4_9b": 4,
                 "mistral_nemo_12b": 4, "mixtral_8x7b": 2, "dbrx_132b": 1,
                 # full depth: 7.27 B, 1.12 B, 1.01 B and 1.89 B parameters
                 "falcon_mamba_7b": 64, "zamba2_1p2b": 38,
                 "whisper_medium": 24, "internvl2_2b": 24}
# the mamba families' decode oracle is held in float32: in bf16 their
# full-depth forward is itself 0.32-0.39 from the float32 forward (bf16
# rounding through 38-64 mamba layers), and decode lands as far from it
# (PERF.md, section 6); the bf16 distances are recorded beside it. At smoke
# size the reference's own bf16 zamba2 decode is already outside 2e-2 of
# its forward, and the port's is as far (tests/test_torch_ssm.py)
ORACLE_F32 = ("falcon_mamba_7b", "zamba2_1p2b")
FAMILY_SEQ = 64
GEMMA_LONG = 4096 + 64          # gemma2's window + 64 decode positions
GEMMA_LONG_LAYERS = 2           # one local and one global layer
LOCAL_BLOCK = dict(S=3 * 4096, Hq=16, Hkv=8, hd=256, window=4096, softcap=50.0)
DECODE_TOL = 2e-2               # rtol = atol, tests/test_models_smoke.py:83
SERVE = dict(batch=4, prompt=32, gen=32)
SERVE_LAYERS = {"qwen3_4b": 4, "gemma2_9b": 4, "mixtral_8x7b": 2,
                "falcon_mamba_7b": 64, "zamba2_1p2b": 38, "internvl2_2b": 24}
# zamba2 is not trained here: its full-width gradient is NaN (mamba2_ssd's
# exp(seg) overflow, the reference's; phase families' hybrid check)
LAUNCH_LAYERS = {"gemma2_9b": 4, "mixtral_8x7b": 1, "falcon_mamba_7b": 1,
                 "whisper_medium": 24}
# the launcher's checkpoint mechanics, at smoke size (full-width states
# would write 12-30 GB a checkpoint)
MECHANICS_ARCHS = ("qwen3_4b", "falcon_mamba_7b", "whisper_medium")
LAUNCH_SEQ, LAUNCH_STEPS = 4096, 3
# Phase dryrun: the production cells it runs (arch, shape, mesh), and the
# band within which the dry run's peak must equal a real step's
DRYRUN_CELLS = (("qwen3_4b", "train_4k", "single"),
                ("qwen3_4b", "prefill_32k", "single"),
                ("qwen3_4b", "decode_32k", "single"),
                ("falcon_mamba_7b", "long_500k", "single"),
                ("qwen3_4b", "train_4k", "multi"))
DRYRUN_MEM_BAND = 0.10
H100_PEAK_FLOPS = 989e12        # dense bf16, the data sheet's
# the hybrid-gradient check: one zamba2-1.2b train step at full width,
# depth cut to 1 layer, at LAUNCH_SEQ; the gradient leaves non-finite
# before clipping, the reference's set (tests/test_torch_ssm.py pins it):
# mamba2_ssd's exp(seg) overflows above the diagonal of a 128-token chunk
HYBRID_NONFINITE = ("embed", "layers/mamba/A_log", "layers/mamba/in_proj",
                    "layers/mamba/ln", "shared_attn/ln", "shared_attn/wk",
                    "shared_attn/wo", "shared_attn/wq", "shared_attn/wv")


START = time.perf_counter()


_LAST_LINE = [START]


def emit(obj) -> None:
    """One JSON line; a phase's line also holds the seconds since the
    script started and since the previous phase line (``phase_s``)."""
    if "phase" in obj:
        now = time.perf_counter()
        obj = {**obj, "elapsed_s": now - START, "phase_s": now - _LAST_LINE[0]}
        _LAST_LINE[0] = now
    print(json.dumps(obj), flush=True)


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def within(got: float, want: float, band: float) -> bool:
    return abs(got - want) <= band * abs(want)


def sweep_cells(group: str) -> list:
    """``(name, ExpSpec fields, run)`` of each cell of ``SWEEPS[group]``:
    its name (with the load where the group's loads differ) and the run
    of ``RUNS`` on the same spec, or None."""
    from repro_torch.netsim import experiment as pexp
    kws = SWEEPS[group]
    loads = len({kw["load"] for kw in kws}) > 1
    out = []
    for kw in kws:
        name = "/".join([group] + ([str(kw["load"])] if loads else [])
                        + [kw["policy"]])
        run = next((r for r, rk in RUNS.items()
                    if pexp.ExpSpec(**rk) == pexp.ExpSpec(**kw)), None)
        out.append((name, kw, run))
    return out


def fidelity_cells(grid: str = "fidelity") -> list:
    """``(name, ExpSpec fields, run)`` of each cell of a fidelity grid
    (``FIDELITY_DURATION``), in fidelity_bench's order: its name and the
    run of ``PACKET_RUNS`` on the same spec, or None."""
    from repro_torch.netsim import experiment as pexp
    dur = FIDELITY_DURATION[grid]
    out = []
    for scen, load in FIDELITY_LOADS.items():
        top = (scen if scen == "testbed8"
               else f"{scen}:deg_ms={max(dur // 5000, 50)}")
        for pol in FIDELITY_POLICIES:
            for eng in ("fluid", "packet"):
                kw = dict(topology=top, load=load, policy=pol, engine=eng,
                          duration_us=dur, seed=1)
                run = next((r for r, rk in PACKET_RUNS.items()
                            if pexp.ExpSpec(**rk) == pexp.ExpSpec(**kw)), None)
                out.append((f"{grid}/{scen}/{pol}/{eng}", kw, run))
    return out


def cosim_cells() -> list:
    """``(name, ExpSpec fields)`` of each cell of phase cosim."""
    return [(f"cosim/{e}/{m}/{p}",
             dict(COSIM, engine=e, cosim_model=m, policy=p))
            for e in ("fluid", "packet") for m in COSIM_MODELS
            for p in COSIM_POLICIES]


def cosim_orderings(numbers: dict) -> dict:
    """fig_training's ordering flag per (engine, model) from each cell's
    ``(p50, p99, iters_done, completed, offered)``: lcmp's strict
    iteration p50 and p99 at or below every baseline's, and lcmp's
    completions at or above ``COMPLETION_FLOOR``."""
    flags = {}
    for e in ("fluid", "packet"):
        for m in COSIM_MODELS:
            def cell(p):
                return numbers[f"cosim/{e}/{m}/{p}"]
            lc = cell("lcmp")
            flags[(e, m)] = (lc[3] / lc[4] >= COMPLETION_FLOOR) and all(
                lc[0] <= cell(p)[0] and lc[1] <= cell(p)[1]
                for p in COSIM_POLICIES if p != "lcmp")
    return flags


def log_pearson(fluid: list, packet: list) -> float:
    """fidelity_bench's cross-engine correlation: Pearson r of the logs."""
    return float(np.corrcoef(np.log(fluid), np.log(packet))[0, 1])


def cuda_ms(fn, iters: int) -> float:
    """Mean time of ``fn`` from CUDA events over ``iters`` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, iters: int) -> float:
    """Device time of one ``fn`` call: ``iters`` calls captured in one
    CUDA graph, one replay timed with CUDA events (no host launch cost)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def timings(kernel, plain, iters: int) -> dict:
    """``ms``/``plain_ms``: device time per call (graph replay);
    ``call_ms``/``plain_call_ms``: time per eager call from the host, as
    the eager engine step pays it."""
    return {"ms": graph_ms(kernel, iters), "plain_ms": graph_ms(plain, iters),
            "call_ms": cuda_ms(kernel, iters), "plain_call_ms": cuda_ms(plain, iters)}


def bound(nbytes: int) -> dict:
    return {"bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}


# ------------------------------------------------------------------ phases
def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    info = {"phase": "device", "nvidia_smi": smi,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "capability": list(torch.cuda.get_device_capability(0))}
    emit(info)
    return info


def phase_build() -> dict:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    kernels = build.build_all(force=True)     # from this checkout's sources
    out = {"phase": "build", "seconds": time.perf_counter() - t0,
           "arch": "sm_90a", "kernels": kernels}
    emit(out)
    return out


def filled_scalars_equal(dev) -> bool:
    """rope's theta, gemma's embedding scale and an int position filled
    on the card (``torch.full``) against the host-built tensors."""
    from repro_torch import configs
    vals = set()
    for c in configs.all_configs().values():
        vals |= {(float(c.rope_theta), torch.float32),
                 (c.d_model ** 0.5, c.adt), (7, torch.long)}
    return all(torch.equal(torch.full((), v, dtype=dt, device=dev)
                           .reshape(1).view(torch.uint8),
                           torch.tensor(v, dtype=dt, device=dev)
                           .reshape(1).view(torch.uint8))
               for v, dt in vals)


def phase_lint(dev) -> dict:
    """Phase lint (see the module docstring); the decode check is
    ``examples/torch_decode_sync.py``'s. The CLI runs in a process of its
    own beside the decode check, and is stopped if it outlives it by
    more than its timeout."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.analysis",
                             "--format=json"], cwd=HERE, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        # every DEV line the lint sees, exempted or not, to name a sync by
        from repro_torch.analysis import run_checks
        rep = run_checks(HERE, checks=["syncs"])
        dev_lines = {(f.path, f.line) for f in rep.findings + rep.suppressed}
        sys.path.insert(0, os.path.join(HERE, "examples"))
        from torch_decode_sync import check as decode_sync
        decode = decode_sync(HERE)["runs"]
        scalars_equal = filled_scalars_equal(dev)
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    lint_s = time.perf_counter() - t0
    try:
        report = json.loads(stdout)
    except json.JSONDecodeError:
        report = {"ok": False, "findings": [], "stderr": stderr[-2000:]}
    for r in decode:
        if r["synced"] is not None:
            r["synced"]["named_by_lint"] = [
                f for f in r["synced"]["frames"] if tuple(f[:2]) in dev_lines]
    out = {"phase": "lint", "exit": proc.returncode, "ok": report.get("ok"),
           "files": report.get("files"), "suppressed": report.get("suppressed"),
           "findings": report.get("findings"), "lint_wall_s": lint_s,
           "dev_lines": sorted(dev_lines), "decode": decode,
           "engines": "phase sanitize: fluid and packet steps 1.. under "
                      "set_sync_debug_mode('error')",
           "filled_scalars_equal": scalars_equal}
    emit(out)
    require(proc.returncode == 0 and out["ok"] is True,
            f"lint: the port's reprolint is clean ({out['findings']})")
    require(out["files"] > 80, "lint: over the port's files")
    for r in decode:
        require(r["synced"] is None,
                f"lint: {r['config']} decode steps 1-{r['steps']} make no "
                f"host sync ({r['synced']})")
        require(r["finite"] and r["shape"][:2] == [r["batch"], 1],
                f"lint: {r['config']} decode logits finite, (batch, 1, V)")
    require(out["filled_scalars_equal"],
            "lint: filled scalars equal the host-built ones bit for bit")
    return out


def main_path_shapes(dev) -> dict:
    """(ports L, arrivals per step A, candidates K, hops H), the switch
    tables, arrays, initial state and config of each checked world, from
    the port's own build."""
    from repro_torch.netsim import experiment as pexp
    from repro_torch.netsim import fluid
    out = {}
    for name, kw in CHECK_WORLDS.items():
        _, table, flows, cfg = pexp.build_experiment(pexp.ExpSpec(**kw))
        arrs, st = fluid.build(table, flows, cfg, device=dev)
        out[name] = dict(L=arrs.link_cap.shape[0], A=arrs.arrivals.shape[1],
                         K=arrs.pair_cand.shape[1], H=arrs.path_links.shape[1],
                         tables=arrs.tables, arrs=arrs, state=st, cfg=cfg)
    return out


def check_cong_update(dev, tables, label: str, iters: int) -> dict:
    from repro_torch.core.cong import CongState
    from repro_torch.kernels import ops, ref
    n = tables.trend_thresh.shape[0]
    rng = np.random.default_rng(n)
    ring = 8
    st_k, st_p = CongState.init(n, dev), CongState.init(n, dev)
    hist_k = torch.zeros((n, ring), dtype=torch.int32, device=dev)
    hist_p = torch.zeros_like(hist_k)
    err = 0
    for tick in range(6):
        hi = 2_000_000 if tick % 3 < 2 else 100      # drains: negative trends
        q = torch.from_numpy(rng.integers(0, hi, n).astype(np.int32)).to(dev)
        st_k, cc_k = ops.cong_update(st_k, q, tick * 200, tables,
                                     hist_c=hist_k, slot=tick % ring)
        st_p, cc_p = ref.cong_update_ref(st_p, q, tick * 200, tables,
                                         hist_c=hist_p, slot=tick % ring)
        torch.cuda.synchronize()
        pairs = [(cc_k, cc_p), (hist_k, hist_p)] + [
            (getattr(st_k, f), getattr(st_p, f)) for f in
            ("queue_cur", "queue_prev", "trend", "dur_cnt", "last_sample")]
        err = max(err, max(int((a.long() - b.long()).abs().max()) for a, b in pairs))
    require(bool((st_p.trend < 0).any()), f"cong_update {label}: negative trends")
    require(err == 0, f"cong_update {label}: kernel equals plain (err {err})")
    tm = timings(lambda: ops.cong_update(st_k, q, 0, tables, hist_c=hist_k,
                                         slot=0),
                 lambda: ref.cong_update_ref(st_p, q, 0, tables,
                                             hist_c=hist_p, slot=0), iters)
    # per port: reads queue_cur, trend, dur_cnt, queue cells and a 15-int
    # trend_thresh row; writes 5 registers, c_cong and one ring slot; the
    # shared q_thresh and level_score once
    b = bound(n * (4 + 15 + 7) * 4 + (15 + 16) * 4)
    return dict(shape=label, N=n, max_abs_err=err, **tm, **b)


def check_lcmp_decide(dev, F: int, P: int, label: str, iters: int) -> dict:
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(F * 8 + P)
    fids = rng.integers(0, 1 << 32, F).astype(np.int64)
    fids[:min(F, len(HASH_EDGES))] = HASH_EDGES[:F]
    c_path = rng.integers(0, 256, (F, P)).astype(np.int32)
    c_cong = rng.integers(0, 256, (F, P)).astype(np.int32)
    valid = rng.random((F, P)) < 0.8
    valid[F // 2] = False                              # no valid candidate
    c_cong[F - 1] = rng.integers(230, 256, P)          # congestion fallback
    inp = [torch.from_numpy(x).to(dev) for x in (fids, c_path, c_cong, valid)]
    got = ops.lcmp_decide(*inp)
    want = ref.lcmp_decide_ref(*inp)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    require(err == 0, f"lcmp_decide {label}: kernel equals plain (err {err})")
    require(int(got[F // 2]) == -1, f"lcmp_decide {label}: -1 without candidates")
    tm = timings(lambda: ops.lcmp_decide(*inp),
                 lambda: ref.lcmp_decide_ref(*inp), iters)
    # per flow: a 32-bit id (the function hashes uint32 ids), P x (4 + 4
    # + 1) candidate bytes, a 4-byte result
    b = bound(F * (4 + 9 * P + 4))
    return dict(shape=label, F=F, P=P, max_abs_err=err, **tm, **b)


def random_state(flat: dict, rng, kind: str) -> dict:
    """A random engine state of a world, as a flat dict of numpy arrays
    in ``netsim.carry``'s layout, made from that world's state ``flat``:
    link queues (some exact multiples of a cell, some just below), the
    ``hist_c`` ring, the congestion registers (negative trends too),
    ``c_cong`` and the per-flow fields, all drawn from ``rng``. ``kind``:
    ``"live"`` keeps every link up, ``"dead"`` takes about two links in
    five down (so some candidates are invalid and, where flows come from
    several pairs, some flows have none), ``"cut"`` takes every link down
    (no flow has a candidate: nothing may be written), ``"fallback"``
    fills the ring with 230-255 (every lcmp decision falls back to rank
    0, every fatpaths decision spills). RedTE's split weights are drawn
    last, 0-299 (zeros too)."""
    s = dict(flat)
    L, R = s["hist_c"].shape
    F = s["flow_path"].shape[0]
    cells = rng.integers(0, 1 << 16, L)
    frac = rng.choice([0.0, 0.0, 1023.75, 512.5, -0.25], L)
    s["q_bytes"] = np.maximum(cells * 1024.0 + frac, 0.0).astype(np.float32)
    lo = 230 if kind == "fallback" else 0
    s["hist_c"] = rng.integers(lo, 256, (L, R)).astype(np.int32)
    s["link_alive"] = rng.random(L) >= {"dead": 0.4, "cut": 1.0}.get(kind, 0.0)
    s["c_cong"] = rng.integers(0, 256, L).astype(np.int32)
    for reg, (a, b) in (("queue_cur", (0, 1 << 16)), ("queue_prev", (0, 1 << 16)),
                        ("trend", (-(1 << 14), 1 << 14)), ("dur_cnt", (0, 64)),
                        ("last_sample", (0, 1 << 20))):
        s["cong." + reg] = rng.integers(a, b, L).astype(np.int32)
    s["flow_path"] = rng.integers(-1, 64, F).astype(np.int32)
    for name in ("remaining", "rate", "cc_target", "extra_wait"):
        s[name] = (rng.random(F) * 1e6).astype(np.float32)
    s["active"] = rng.random(F) < 0.5
    s["rtt_steps"] = rng.integers(1, 100, F).astype(np.int32)
    s["route_step"] = rng.integers(0, 4000, F).astype(np.int32)
    s["redte_w"] = rng.integers(0, 300, s["redte_w"].shape).astype(np.int32)
    return s


def random_degrade(arrays: dict, rng) -> dict:
    """A world's arrays (flat, ``netsim.carry``'s layout) with a degrade
    schedule drawn from ``rng``: about a third of the links degrade to
    0.1, 0.25 or 0.5 of their capacity from a step in [0, 2000), so
    ``matchrdma``'s effective capacities differ before and after."""
    a = dict(arrays)
    L = a["link_cap"].shape[0]
    on = rng.random(L) < 0.35
    a["link_deg_step"] = np.where(on, rng.integers(0, 2000, L),
                                  a["link_deg_step"]).astype(np.int32)
    a["link_deg_factor"] = np.where(on, rng.choice([0.1, 0.25, 0.5], L),
                                    a["link_deg_factor"]).astype(np.float32)
    return a


def check_rows(arrivals: np.ndarray, max_sig: int) -> list:
    """Rows of ``arrivals`` (T, A) that a route check runs: flow 0's
    (whose other slots may be pads), the first rows with flows below the
    largest signal delay (negative ring offsets), the row with the most
    arrivals, the last row with flows, and an all-pad row if any."""
    has = arrivals >= 0
    busy = np.nonzero(has.any(1))[0]
    rows = {int(np.nonzero((arrivals == 0).any(1))[0][0]),
            int(np.argmax(has.sum(1))), int(busy[-1])}
    rows |= {int(t) for t in busy[busy < max_sig][:3]}
    rows |= {int(t) for t in np.nonzero(~has.any(1))[0][:1]}
    return sorted(rows)


def stranded_row(ar, st) -> int:
    """The arrival row of the first flow that has no valid candidate in
    state ``st`` (every candidate crosses a dead link), or -1."""
    from repro_torch.kernels import ref
    _, _, valid = ref.candidate_view(ar.f_pair, st, ar)
    stranded = torch.nonzero(~valid.any(1)).flatten()
    if stranded.numel() == 0:
        return -1
    return int(torch.nonzero((ar.arrivals == stranded[0]).any(1))[0, 0])


def clone_state(st):
    """A copy of a ``SimState`` whose tensors the kernels may write."""
    import dataclasses

    from repro_torch.core.cong import CongState
    cong = CongState(**{f.name: getattr(st.cong, f.name).clone()
                        for f in dataclasses.fields(CongState)})
    return dataclasses.replace(st, cong=cong, **{
        f.name: getattr(st, f.name).clone() for f in dataclasses.fields(st)
        if f.name != "cong"})


def state_err(a, b, names) -> float:
    """The largest difference over the named tensors of two states."""
    return max(float((getattr(a, n).double() - getattr(b, n).double())
                     .abs().max()) if getattr(a, n).numel() else 0.0
               for n in names)


def candidate_bytes(arr: dict, pairs: np.ndarray, policy: str, sig_step: int,
                    ring: int) -> int:
    """The bytes ``policy``'s law must read for the candidates of the
    distinct pairs ``pairs``, each element once: the pairs' candidate
    rows; each distinct candidate path's hop links and the liveness of
    the links they cross; for the view laws each path's signal delays
    and the distinct ring cells they read; per path its C_path (lcmp
    family), capacity (lcmp_w, ucmp, wcmp) or hop count (fatpaths); the
    pairs' RedTE rows (redte); each link's capacity, degrade step and
    factor (matchrdma). ``arr``: numpy arrays by field name. Under
    ``"sweep"`` each pair's law code (4 bytes) and then each law's bytes
    over its own pairs."""
    if policy == "sweep":
        code = arr["pair_policy"][pairs]
        return 4 * pairs.size + sum(
            candidate_bytes(arr, pairs[code == c], LAWS[c], sig_step, ring)
            for c in np.unique(code))
    K, H = arr["pair_cand"].shape[1], arr["path_links"].shape[1]
    nbytes = 4 * K * pairs.size
    cand = np.unique(arr["pair_cand"][pairs])
    cand = cand[cand >= 0]
    hops = arr["path_links"][cand]
    links = np.unique(hops[hops >= 0])
    nbytes += 4 * H * cand.size + links.size
    if policy in VIEW_LAWS:
        slots = (sig_step - arr["path_sig_delay"][cand]) % ring
        cells = np.unique((hops.astype(np.int64) * ring + slots)[hops >= 0])
        nbytes += 4 * H * cand.size + 4 * cells.size
    per_path = {"lcmp": 1, "lcmp_r": 1, "lcmp_w": 2, "ucmp": 1, "wcmp": 1,
                "fatpaths": 1}.get(policy, 0)
    nbytes += 4 * per_path * cand.size
    if policy == "redte":
        nbytes += 4 * K * pairs.size
    if policy == "matchrdma":
        nbytes += 12 * links.size
    return nbytes


def _numpy_arrays(ar) -> dict:
    return {n: getattr(ar, n).cpu().numpy() for n in (
        "arrivals", "f_pair", "pair_cand", "path_links", "path_sig_delay",
        "pair_policy") if getattr(ar, n) is not None}


def row_laws(ar, pairs: torch.Tensor, policy: str) -> np.ndarray:
    """The law of each decision for pairs ``pairs``: ``policy``, or under
    ``"sweep"`` each pair's own (``ar.pair_policy``)."""
    if policy != "sweep":
        return np.full(pairs.shape[0], policy)
    return np.asarray(LAWS)[ar.pair_policy[pairs].cpu().numpy()]


def route_bound(ar, st, t: int, policy: str, out) -> dict:
    """The bytes route_arrivals must move for row ``t`` from state
    ``st``, each element read once: the row; the arriving flows' pair,
    id and size; ``candidate_bytes`` of their pairs; the chosen paths'
    links' queues and capacities, delay and rate; and 29 bytes written
    per routed flow (``out``: the plain version's state after the row)."""
    from repro_torch.kernels import ref
    arr = _numpy_arrays(ar)
    row = arr["arrivals"][t]
    flows = row[row >= 0]
    nbytes = 4 * row.size + 16 * flows.size
    nbytes += candidate_bytes(arr, np.unique(arr["f_pair"][flows]), policy, t,
                              st.hist_c.shape[1])
    _, _, valid = ref.candidate_view(ar.f_pair[torch.from_numpy(flows).to(
        ar.f_pair.device).long()], st, ar)
    routed = flows[valid.any(1).cpu().numpy()]
    paths = np.unique(out.flow_path.cpu().numpy()[routed])
    links = arr["path_links"][paths]
    nbytes += 8 * np.unique(links[links >= 0]).size + 8 * paths.size
    nbytes += 29 * routed.size
    return bound(int(nbytes))


def decide_bound(ar, st, policy: str, sig_step: int) -> dict:
    """The bytes ``decide`` must move for every flow's decision: per
    decision a 32-bit key, the pair and two 4-byte results, and
    ``candidate_bytes`` of the distinct pairs."""
    arr = _numpy_arrays(ar)
    N = arr["f_pair"].size
    return bound(int(16 * N + candidate_bytes(arr, np.unique(arr["f_pair"]),
                                               policy, sig_step,
                                               st.hist_c.shape[1])))


def host_us(fn, calls: int = 2000) -> float:
    """Host time per call of ``fn``, in microseconds, over ``calls``
    calls that only enqueue work (the device work is synchronised after
    the clock stops, and the queue is far from full)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def check_route(dev, ar, st0, policy: str, label: str, iters: int, select,
                dt_us: int, rows: list) -> dict:
    """route_arrivals against its plain version from state ``st0``, row
    by row: every field the kernel writes, and every flow it must not
    write, equal bit for bit; with ``iters``, the kernel and its plain
    version are timed on the row with the most arrivals."""
    from repro_torch.kernels import ops, ref
    st_k, st_p = clone_state(st0), st0
    before = ops.counts()["route_arrivals"]
    err, routed, dropped, fallback, dead, laws = 0.0, 0, 0, 0, 0, set()
    for t in rows:
        ops.route_arrivals(t, st_k, ar, policy, select, dt_us)
        st_p = ref.route_arrivals_ref(t, st_p, ar, policy, select, dt_us)
        torch.cuda.synchronize()
        err = max(err, state_err(st_k, st_p, FLOW_FIELDS))
        row = ar.arrivals[t]
        flows = row[row >= 0].long()
        cand, hop, valid = ref.candidate_view(ar.f_pair[flows], st_p, ar)
        routed += int(valid.any(1).sum())
        dropped += int((~valid.any(1)).sum())
        dead += int((~valid & (cand >= 0)).sum())
        law = row_laws(ar, ar.f_pair[flows], policy)
        laws |= set(law[valid.any(1).cpu().numpy()])
        view = torch.from_numpy(np.isin(law, VIEW_LAWS)).to(dev)
        if bool(view.any()):
            _, c_cong = ref.lcmp_scores(t, cand, hop, st_p, ar)
            low = torch.where(valid, c_cong, 256).amin(1)
            fallback += int(((low >= select.cong_fallback) & valid.any(1)
                             & view).sum())
    require(err == 0, f"route_arrivals {label}: kernel equals plain, written "
            f"and unwritten fields (err {err})")
    require(ops.counts()["route_arrivals"] == before + len(rows),
            f"route_arrivals {label}: one launch a row, all-pad rows too")
    out = dict(shape=label, rows=rows, routed=routed, no_candidate=dropped,
               dead_candidates=dead, fallback=fallback, laws=len(laws),
               max_abs_err=err)
    if iters:
        full = int(np.argmax((ar.arrivals >= 0).sum(1).cpu().numpy()))
        launch = ops.RouteArrivals(ar, st_k, policy, select, dt_us)
        # host time per call: with the queues and flow fields new at
        # every call (two states in turn: every tensor is checked, more
        # than the main path's step, which keeps four of the nine) and
        # with the same ones (none is checked again)
        turn = itertools.cycle([st_k, clone_state(st_k)])
        out.update(timed_row=full, **timings(
            lambda: launch(full, st_k),
            lambda: ref.route_arrivals_ref(full, st_p, ar, policy, select, dt_us),
            iters), host_us=host_us(lambda: launch(full, next(turn))),
            host_us_same_tensors=host_us(lambda: launch(full, st_k)),
            **route_bound(ar, st_p, full, policy,
                          ref.route_arrivals_ref(full, st_p, ar, policy,
                                                 select, dt_us)))
    return out


def check_monitor(dev, tables, label: str, iters: int) -> dict:
    """monitor_tick against its plain version over 6 ticks from random
    registers: queues in bytes (exact cells, cells minus a fraction,
    drains), registers, c_cong and the ring slot bit for bit; with
    ``iters``, the launcher and the plain version are then timed."""
    from repro_torch.core.cong import CongParams, CongState
    from repro_torch.kernels import ops, ref
    n = tables.trend_thresh.shape[0]
    rng = np.random.default_rng(n + 1)
    ring = 8
    init = {r: torch.from_numpy(rng.integers(a, b, n).astype(np.int32)).to(dev)
            for r, (a, b) in (("queue_cur", (0, 1 << 16)),
                              ("queue_prev", (0, 1 << 16)),
                              ("trend", (-(1 << 14), 1 << 14)),
                              ("dur_cnt", (0, 64)), ("last_sample", (0, 1 << 20)))}
    st_k = CongState(**{r: v.clone() for r, v in init.items()})
    st_p = CongState(**init)
    hist_k = torch.zeros((n, ring), dtype=torch.int32, device=dev)
    hist_p = torch.zeros_like(hist_k)
    cc_k = torch.full((n,), -1, dtype=torch.int32, device=dev)
    params = CongParams()
    before = ops.counts()["monitor_tick"]
    err = 0
    for tick in range(6):
        hi = 1 << 21 if tick % 3 < 2 else 64          # drains: negative trends
        cells = rng.integers(0, hi, n)
        frac = rng.choice([0.0, 1023.75, 512.5, 0.25], n)
        q = torch.from_numpy((cells * 1024.0 + frac).astype(np.float32)).to(dev)
        st_k, cc_k = ops.monitor_tick(st_k, q, tick * 200, tables, params,
                                      hist_k, tick % ring, cc_k)
        st_p, cc_p = ref.monitor_tick_ref(st_p, q, tick * 200, tables, params,
                                          hist_p, tick % ring)
        torch.cuda.synchronize()
        pairs = [(cc_k, cc_p), (hist_k, hist_p)] + [
            (getattr(st_k, f), getattr(st_p, f)) for f in
            ("queue_cur", "queue_prev", "trend", "dur_cnt", "last_sample")]
        err = max(err, max(int((a.long() - b.long()).abs().max()) for a, b in pairs))
    require(bool((st_p.trend < 0).any()), f"monitor_tick {label}: negative trends")
    require(err == 0, f"monitor_tick {label}: kernel equals plain (err {err})")
    require(ops.counts()["monitor_tick"] == before + 6,
            f"monitor_tick {label}: one launch a tick")
    out = dict(shape=label, N=n, max_abs_err=err)
    if iters:
        launch = ops.MonitorTick(st_k, cc_k, hist_k, tables, params, 0)
        turn = itertools.cycle([q, q.clone()])   # new queues every step
        out.update(**timings(
            lambda: launch(q, 0, 0),
            lambda: ref.monitor_tick_ref(st_p, q, 0, tables, params, hist_p, 0),
            iters), host_us=host_us(lambda: launch(next(turn), 0, 0)),
            # per port: reads the queue, queue_cur, trend, dur_cnt and a
            # 15-int trend_thresh row; writes 5 registers, c_cong and one
            # ring slot; the shared q_thresh and level_score once
            **bound(n * (4 + 15 + 7) * 4 + (15 + 16) * 4))
    return out


def bulk_route_world(dev, seed: int = 0):
    """A synthetic world at ``ROUTE_BULK``'s shape: 2^20 flows, random
    paths of 1-8 hops over 2^20 links, pairs of 1-8 candidates, 4096
    arrival slots a row (row 0 with 30% pads, row 1 all pads), 2% of
    links down, a random ring and queues, random capacities (some 0),
    degrade steps and factors and RedTE weights. Returns ``(ar, st)`` as
    ``SimArrays`` and ``SimState``; the fields the route and decide do
    not read are empty."""
    import dataclasses

    from repro_torch.core.cong import CongState
    from repro_torch.netsim.engine import SimArrays, SimState
    b = ROUTE_BULK
    rng = np.random.default_rng(seed)
    A, T, L, NP, H, K, F = (b["A"], b["T"], b["L"], b["NP"], b["H"], b["K"],
                            b["F"])
    arrivals = rng.permutation(F)[:A * T].reshape(T, A).astype(np.int32)
    arrivals[0, rng.random(A) < 0.3] = -1
    arrivals[1] = -1
    path_links = rng.integers(0, L, (NP, H)).astype(np.int32)
    path_links[np.arange(H) >= rng.integers(1, H + 1, NP)[:, None]] = -1
    pair_cand = rng.integers(0, NP, (b["NPAIR"], K)).astype(np.int32)
    pair_cand[np.arange(K) >= rng.integers(1, K + 1, b["NPAIR"])[:, None]] = -1
    f_id = rng.integers(0, 1 << 32, F).astype(np.int64)
    f_id[:len(HASH_EDGES)] = HASH_EDGES

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    empty = torch.empty(0, device=dev)
    ar = SimArrays(**{f.name: empty for f in dataclasses.fields(SimArrays)})
    ar = dataclasses.replace(
        ar, arrivals=t(arrivals),
        f_pair=t(rng.integers(0, b["NPAIR"], F).astype(np.int32)), f_id=t(f_id), f_size=t((rng.random(F) * 1e7).astype(np.float32)),
        pair_cand=t(pair_cand), path_links=t(path_links),
        path_sig_delay=t(rng.integers(0, 3 * b["ring"], (NP, H)).astype(np.int32)),
        path_prop=t(rng.integers(50, 60_000, NP).astype(np.int32)),
        path_cap=t((rng.random(NP) * 100 + 1).astype(np.float32)),
        link_cap=t((rng.random(L) * 100 + 1).astype(np.float32)),
        path_cap_gbps=t(rng.choice([0, 25, 40, 100, 400], NP).astype(np.int32)),
        path_len=t((path_links >= 0).sum(1).astype(np.int32)),
        link_cap_gbps=t(rng.choice([25, 40, 100, 400], L).astype(np.int32)),
        link_deg_step=t(rng.integers(0, 2 * T, L).astype(np.int32)),
        link_deg_factor=t(rng.choice([0.1, 0.25, 1.0], L).astype(np.float32)),
        tables=None)
    st = SimState(cong=CongState.init(0, dev), **{
        f.name: empty for f in dataclasses.fields(SimState) if f.name != "cong"})
    st = dataclasses.replace(
        st, q_bytes=t((rng.random(L) * 1e7).astype(np.float32)),
        hist_c=t(rng.integers(0, 256, (L, b["ring"])).astype(np.int32)),
        link_alive=t(rng.random(L) >= 0.02),
        c_path=t(rng.integers(0, 256, NP).astype(np.int32)),
        flow_path=t(rng.integers(-1, 64, F).astype(np.int32)),
        remaining=t((rng.random(F) * 1e6).astype(np.float32)),
        rate=t((rng.random(F) * 1e3).astype(np.float32)),
        cc_target=t((rng.random(F) * 1e3).astype(np.float32)),
        active=t(rng.random(F) < 0.5),
        extra_wait=t((rng.random(F) * 1e3).astype(np.float32)),
        rtt_steps=t(rng.integers(1, 100, F).astype(np.int32)),
        route_step=t(rng.integers(0, 4000, F).astype(np.int32)),
        redte_w=t(rng.integers(0, 300, (b["NPAIR"], K)).astype(np.int32)))
    return ar, st


def world_state(dev, world: dict, kind: str, seed: int):
    """``random_state`` of a built world, with ``random_degrade``'s
    schedule in its arrays, on ``dev``."""
    from repro_torch.netsim import carry
    rng = np.random.default_rng(seed)
    flat = random_state(carry.to_numpy(world["state"]), rng, kind)
    arrs = random_degrade(carry.to_numpy(world["arrs"]), rng)
    return carry.from_reference(arrs, flat, device=dev)


def mixed_laws(ar, seed: int):
    """``ar`` with a random law per pair drawn over all ten codes, the
    pairs that carry flows taking every law in turn when they are ten or
    more (``pair_policy``, as a merged sweep world holds it)."""
    import dataclasses
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, len(LAWS), ar.pair_cand.shape[0])
    used = np.unique(ar.f_pair.cpu().numpy())
    codes[used] = rng.permutation(len(used)) % len(LAWS)
    return dataclasses.replace(ar, pair_policy=torch.from_numpy(
        codes.astype(np.int32)).to(ar.pair_cand.device))


def merged_shape(dev) -> dict:
    """The merged world of the fig5 group (``SWEEPS["fig5"]``, 15 cells)
    from the port's own build, in ``main_path_shapes``' layout."""
    from repro_torch.netsim import experiment as pexp
    from repro_torch.netsim import sweep
    g = sweep.build_group([pexp.ExpSpec(**kw) for kw in SWEEPS["fig5"]],
                          device=dev)
    return dict(L=g.arrs.link_cap.shape[0], A=g.arrs.arrivals.shape[1],
                K=g.arrs.pair_cand.shape[1], H=g.arrs.path_links.shape[1],
                C=len(g.specs), tables=g.arrs.tables, arrs=g.arrs,
                state=g.state, cfg=g.cfg)


def route_checks(dev, shapes) -> tuple:
    """route_arrivals at each world's shape (every law; live, dead, cut
    and fallback states; the rows of ``check_rows``, and for the dead
    state the row of a flow without candidates where there is one) and
    at the bulk shape (lcmp and ecmp). Timed: lcmp and ecmp in every
    world, the other laws at testbed8's shape, live states. Returns
    (timed rows, every case)."""
    timed, cases = [], []
    for name, w in shapes.items():
        cfg = w["cfg"]
        rows = check_rows(w["arrs"].arrivals.cpu().numpy(),
                          int(w["arrs"].path_sig_delay.max()))
        for i, kind in enumerate(("live", "dead", "cut", "fallback")):
            ar, st = world_state(dev, w, kind, seed=17 * i + len(name))
            extra = [stranded_row(ar, st)] if kind == "dead" else []
            for policy in LAWS:
                timed_case = kind == "live" and (
                    policy in ("lcmp", "ecmp") or name == "testbed8")
                r = check_route(dev, ar, st, policy,
                                f"{name} {policy} {kind} A={w['A']} K={w['K']} "
                                f"H={w['H']}", 200 if timed_case else 0,
                                cfg.select, cfg.dt_us,
                                sorted(set(rows + extra) - {-1}))
                (timed if timed_case else cases).append(r)
                if kind == "dead":
                    require(r["dead_candidates"] > 0 and r["routed"] > 0,
                            f"route {name} {policy}: dead links, flows routed")
                if kind == "cut":
                    require(r["routed"] == 0 and r["no_candidate"] > 0,
                            f"route {name} {policy}: no flow has a candidate")
                if kind == "fallback" and policy in VIEW_LAWS:
                    require(r["fallback"] > 0, f"route {name} {policy}: the "
                            "fallback ran")
    ar, st = bulk_route_world(dev)
    from repro_torch.core.select import SelectParams
    b = ROUTE_BULK
    for policy in LAWS:
        r = check_route(dev, ar, st, policy, f"bulk {policy} A={b['A']} "
                        f"L={b['L']} K={b['K']} H={b['H']}",
                        20 if policy in ("lcmp", "ecmp") else 0,
                        SelectParams(), 200, list(range(b["T"])))
        (timed if policy in ("lcmp", "ecmp") else cases).append(r)
    r = check_route(dev, mixed_laws(ar, 7), st, "sweep", f"bulk sweep (a law "
                    f"per pair) A={b['A']} L={b['L']} K={b['K']} H={b['H']}",
                    0, SelectParams(), 200, list(range(b["T"])))
    require(r["laws"] == len(LAWS), "route bulk sweep: every law decided")
    cases.append(r)
    return timed, cases


def sweep_route_checks(dev, w: dict) -> tuple:
    """route_arrivals with a random law per pair (``mixed_laws``) on the
    merged fig5 world: live (timed), dead, cut and fallback states with a
    degrade schedule, the rows of ``check_rows``. Returns (timed rows,
    other cases)."""
    rows = check_rows(w["arrs"].arrivals.cpu().numpy(),
                      int(w["arrs"].path_sig_delay.max()))
    timed, cases = [], []
    for i, kind in enumerate(("live", "dead", "cut", "fallback")):
        ar, st = world_state(dev, w, kind, seed=91 + i)
        ar = mixed_laws(ar, i)
        extra = [stranded_row(ar, st)] if kind == "dead" else []
        r = check_route(dev, ar, st, "sweep",
                        f"fig5 merged {w['C']} cells, a law per pair, {kind} "
                        f"A={w['A']} L={w['L']} K={w['K']} H={w['H']}",
                        200 if kind == "live" else 0, w["cfg"].select,
                        w["cfg"].dt_us, sorted(set(rows + extra) - {-1}))
        (timed if kind == "live" else cases).append(r)
        if kind == "cut":
            require(r["routed"] == 0 and r["no_candidate"] > 0,
                    "route fig5 merged cut: no flow has a candidate")
            continue
        require(r["routed"] > 0 and r["laws"] >= 5,
                f"route fig5 merged {kind}: flows of several laws routed")
        if kind == "dead":
            require(r["dead_candidates"] > 0, "route fig5 merged: dead links")
        if kind == "fallback":
            require(r["fallback"] > 0, "route fig5 merged: the fallback ran")
    return timed, cases


def check_decide(dev, ar, st, policy: str, label: str, iters: int, select,
                 cases: list) -> dict:
    """``decide`` against its plain version for every flow of ``ar``, at
    each ``(t, sig_step, salted)`` of ``cases`` (salted: keys xor
    fmix32(nonce), as the re-decision hashes): k_idx and chosen equal bit
    for bit, and the first kernel's table of per-pair records, unpacked
    here on the host, equal to ``ref.decide_records_ref`` field for
    field (``table_err``); one call a case; with ``iters``, timed at the
    first case, the whole call and each of its two kernels alone
    (``pairs_ms``, ``pick_ms``)."""
    from repro_torch.core.select import fmix32
    from repro_torch.kernels import lcmp_decide, ops, ref
    launch = ops.RouteArrivals(ar, st, policy, select, 200)
    nonce = torch.arange(ar.f_id.shape[0], device=ar.f_id.device) % 5
    salted = ar.f_id ^ fmix32(nonce)
    before = ops.counts()["decide"]
    err, table_err, decided, none, laws = 0, 0, 0, 0, set()
    for t, sig, salt in cases:
        fid = salted if salt else ar.f_id
        k, c = launch.decide(t, fid, ar.f_pair, sig)
        kp, cp = ref.decide_ref(t, fid, ar.f_pair, st, ar, policy, select, sig)
        want = ref.decide_records_ref(t, sig, st, ar, policy, select)
        got = lcmp_decide.unpack_records(launch.records)
        torch.cuda.synchronize()
        err = max(err, int((k.long() - kp.long()).abs().max()),
                  int((c.long() - cp.long()).abs().max()))
        table_err = max(table_err, *(int((got[f].long() - w.long()).abs().max())
                                     for f, w in want.items()))
        decided += int((kp >= 0).sum())
        none += int((kp < 0).sum())
        laws |= set(row_laws(ar, ar.f_pair[kp >= 0], policy))
    require(err == 0, f"decide {label}: kernel equals plain (err {err})")
    require(table_err == 0, f"decide {label}: the per-pair table equals "
            f"decide_records_ref (err {table_err})")
    require(ops.counts()["decide"] == before + len(cases),
            f"decide {label}: one launch a call")
    out = dict(shape=label, N=int(ar.f_id.shape[0]), cases=cases,
               decided=decided, no_candidate=none, laws=len(laws),
               max_abs_err=err, table_err=table_err)
    if iters:
        t, sig, _ = cases[0]
        pairs, pick = launch.decide_stages(t, ar.f_id, ar.f_pair, sig)
        out.update(**timings(
            lambda: launch.decide(t, ar.f_id, ar.f_pair, sig),
            lambda: ref.decide_ref(t, ar.f_id, ar.f_pair, st, ar, policy,
                                   select, sig), iters),
            pairs_ms=graph_ms(pairs, iters), pick_ms=graph_ms(pick, iters),
            host_us=host_us(lambda: launch.decide(t, ar.f_id, ar.f_pair, sig)),
            **decide_bound(ar, st, policy, sig))
    return out


def decide_checks(dev, shapes) -> tuple:
    """``decide`` for every law over all of wan2000's flows (dead links,
    a degrade schedule, and the fallback state) and over 2^20 flows of
    the bulk world, at the failover's read (t = 0, ring step -1), a
    mid-run step and salted keys. Timed: every law at wan2000's shape,
    lcmp and ecmp at the bulk shape. Returns (timed rows, every case)."""
    from repro_torch.core.select import SelectParams
    timed, cases = [], []
    w = shapes["wan2000"]
    for i, kind in enumerate(("dead", "fallback")):
        ar, st = world_state(dev, w, kind, seed=41 + i)
        for policy in LAWS:
            r = check_decide(dev, ar, st, policy,
                             f"wan2000 {policy} {kind} N={w['arrs'].f_id.shape[0]} "
                             f"K={w['K']} H={w['H']}", 200 if kind == "dead" else 0,
                             w["cfg"].select, [(1500, 1499, False), (0, -1, False),
                                               (1500, 1500, True)])
            (timed if kind == "dead" else cases).append(r)
            require(r["decided"] > 0, f"decide wan2000 {policy} {kind}: decided")
            if kind == "dead":
                require(r["no_candidate"] > 0,
                        f"decide wan2000 {policy}: flows with no live candidate")
    ar, st = bulk_route_world(dev)
    b = ROUTE_BULK
    for policy in LAWS:
        r = check_decide(dev, ar, st, policy, f"bulk {policy} N={b['F']} "
                         f"K={b['K']} H={b['H']}",
                         20 if policy in ("lcmp", "ecmp") else 0, SelectParams(),
                         [(2, 1, False), (0, -1, False), (3, 3, True)])
        (timed if policy in ("lcmp", "ecmp") else cases).append(r)
    cases.append(check_decide(dev, mixed_laws(ar, 8), st, "sweep",
                              f"bulk sweep (a law per pair) N={b['F']} "
                              f"K={b['K']} H={b['H']}", 0, SelectParams(),
                              [(2, 1, False), (0, -1, False), (3, 3, True)]))
    return timed, cases


def sweep_decide_checks(dev, w: dict) -> tuple:
    """``decide`` with a random law per pair over every flow of the merged
    fig5 world: dead links with a degrade (timed) and the fallback, at the
    failover's read (t = 0, ring step -1), a mid-run step and salted
    keys. Returns (timed rows, other cases)."""
    timed, cases = [], []
    for i, kind in enumerate(("dead", "fallback")):
        ar, st = world_state(dev, w, kind, seed=95 + i)
        r = check_decide(dev, mixed_laws(ar, 3 + i), st, "sweep",
                         f"fig5 merged {w['C']} cells, a law per pair, {kind} "
                         f"N={w['arrs'].f_id.shape[0]} K={w['K']} H={w['H']}",
                         200 if kind == "dead" else 0, w["cfg"].select,
                         [(1500, 1499, False), (0, -1, False),
                          (1500, 1500, True)])
        (timed if kind == "dead" else cases).append(r)
        require(r["decided"] > 0 and r["laws"] >= (
            len(LAWS) if kind == "fallback" else 5),
            f"decide fig5 merged {kind}: flows of each law decided")
    return timed, cases


def bulk_tables(dev, n: int):
    """Switch tables for ``n`` ports: the five link rates of the worlds,
    each port's trend row gathered from its rate's row."""
    import dataclasses

    from repro_torch.core.tables import bootstrap_tables
    rates = [25, 40, 100, 200, 400]
    small = bootstrap_tables(rates, buffer_bytes=10**9, sample_interval_us=200,
                             device=dev)
    pick = torch.from_numpy(np.random.default_rng(0).integers(0, 5, n)).to(dev)
    return dataclasses.replace(small,
                               trend_thresh=small.trend_thresh[pick].contiguous())


def refuses_wide_sets(dev) -> bool:
    """The card has no route for candidate sets wider than the kernel's
    8 slots: the wrapper must raise, not fall back."""
    from repro_torch.kernels import ops
    F, P = 4, 9
    inp = (torch.zeros(F, dtype=torch.int64, device=dev),
           torch.zeros((F, P), dtype=torch.int32, device=dev),
           torch.zeros((F, P), dtype=torch.int32, device=dev),
           torch.ones((F, P), dtype=torch.bool, device=dev))
    try:
        ops.lcmp_decide(*inp)
    except ValueError:
        return True
    return False


def train_config():
    import dataclasses

    from repro_torch import configs
    return dataclasses.replace(configs.get("qwen3_4b"), n_layers=TRAIN_LAYERS)


def qsr_bound(name: str, n: int) -> dict:
    return bound(QSR_BYTES[name] * n + 4 * (n // 1024))


def qsr_inputs(dev, n: int, seed: int):
    """x: normal values, each 1024-block scaled by 1e-3, 1 or 100; block
    0 zero; in block 1 one value at -amax and one at +amax. bits: the
    wire's own counter stream."""
    from repro_torch.dist import compress
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn(n, generator=gen, device=dev)
    pick = torch.randint(0, 3, (n // 1024,), generator=gen, device=dev)
    mag = torch.tensor([1e-3, 1.0, 100.0], device=dev)[pick]
    x = (x.view(-1, 1024) * mag[:, None]).view(-1)
    x[:1024] = 0.0
    if n >= 2048:
        a = float(x[1024:2048].abs().max()) * 2
        x[1024 + 5], x[1024 + 9] = -a, a
    return x, compress.rand_bits(n, seed, salt=1, device=dev)


def check_qsr(dev, n: int, label: str, iters: int):
    """Both qsr kernels against their plain versions at ``n`` elements:
    identical q, scales and dequantized values; then their times."""
    from repro_torch.kernels import ops, ref
    x, bits = qsr_inputs(dev, n, n % 1009)
    q, s = ops.qsr_int8(x, bits)
    qp, sp = ref.qsr_int8_ref(x, bits)
    y = ops.qsr_dequant(q, s)
    yp = ref.qsr_dequant_ref(qp, sp)
    torch.cuda.synchronize()
    q_err = 0 if torch.equal(q, qp) else int((q.int() - qp.int()).abs().max())
    s_err = float((s - sp).abs().max())
    y_err = 0.0 if torch.equal(y, yp) else float((y - yp).abs().max())
    require(q_err == 0 and s_err == 0, f"qsr_int8 {label}: kernel equals plain "
            f"(q err {q_err}, scale err {s_err})")
    require(y_err == 0, f"qsr_dequant {label}: kernel equals plain (err {y_err})")
    require(bool((q[:1024] == 0).all()) and float(s[0]) == 0.0,
            f"qsr_int8 {label}: a zero block gives q = 0 and scale 0")
    if n >= 2048:
        require(int(q[1024 + 5]) in (-127, -126) and int(q[1024 + 9]) in (126, 127),
                f"qsr_int8 {label}: values at -amax and +amax at the clip edge")
    del qp, sp, y, yp
    tq = timings(lambda: ops.qsr_int8(x, bits),
                 lambda: ref.qsr_int8_ref(x, bits), iters)
    td = timings(lambda: ops.qsr_dequant(q, s),
                 lambda: ref.qsr_dequant_ref(q, s), iters)
    quant = dict(shape=label, N=n, max_abs_err=q_err, scale_err=s_err, **tq,
                 **qsr_bound("qsr_int8", n))
    dequant = dict(shape=label, N=n, max_abs_err=y_err, **td,
                   **qsr_bound("qsr_dequant", n))
    return quant, dequant


def qsr_unbiased(dev) -> float:
    """Stochastic rounding's mean over 64 seeds (|mean - x| <= 2e-3, as
    the reference's kernel test holds it)."""
    from repro_torch.dist import compress
    from repro_torch.kernels import ops
    n = 2048
    x = torch.zeros(n, device=dev)
    x[1024:] = 0.3
    acc = torch.zeros(n, dtype=torch.float64, device=dev)
    for seed in range(64):
        q, s = ops.qsr_int8(x, compress.rand_bits(n, seed, device=dev))
        acc += ops.qsr_dequant(q, s).double()
    acc /= 64
    require(bool((acc[:1024] == 0).all()), "qsr: zero block stays zero")
    return float((acc[1024:] - 0.3).abs().max())


def phase_kernel_check(dev, shapes) -> dict:
    from repro_torch.dist import lcmp_collectives as lc
    cong, decide, monitor = [], [], []
    section_s, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        section_s[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
    for name, s in shapes.items():
        monitor.append(check_monitor(dev, s["tables"], f"{name} N={s['L']}", 200))
        if name in WORLDS:
            cong.append(check_cong_update(dev, s["tables"], f"{name} N={s['L']}", 200))
            decide.append(check_lcmp_decide(dev, s["A"], s["K"],
                                             f"{name} F={s['A']} P={s['K']}", 200))
    # the standalone entries at the shapes phase switch launches them at
    # (first: the kernels line's standalone rows read it)
    cong.insert(0, check_cong_update(dev, switch_inputs(dev)[0],
                                     f"switch N={SWITCH['ports']}", 200))
    decide.insert(0, check_lcmp_decide(
        dev, SWITCH["batch"], SWITCH["cands"],
        f"switch F={SWITCH['batch']} P={SWITCH['cands']}", 200))
    tables = bulk_tables(dev, BULK)
    monitor.append(check_monitor(dev, tables, f"bulk N={BULK}", 20))
    cong.append(check_cong_update(dev, tables, f"bulk N={BULK}", 20))
    del tables
    for P in range(2, 9):
        decide.append(check_lcmp_decide(dev, BULK, P, f"bulk F={BULK} P={P}", 20))
    lap("standalone")
    route, route_cases = route_checks(dev, shapes)
    torch.cuda.empty_cache()
    lap("route")
    decide_timed, decide_cases = decide_checks(dev, shapes)
    torch.cuda.empty_cache()
    lap("decide")
    # the fig5 group's merged world: the tick over its C x L ports, and
    # route and decide with a law per pair
    merged = merged_shape(dev)
    monitor.append(check_monitor(dev, merged["tables"],
                                 f"fig5 merged N={merged['L']}", 200))
    timed, cases = sweep_route_checks(dev, merged)
    route, route_cases = route + timed, route_cases + cases
    timed, cases = sweep_decide_checks(dev, merged)
    decide_timed, decide_cases = decide_timed + timed, decide_cases + cases
    del merged
    torch.cuda.empty_cache()
    lap("merged")
    leg1, leg2 = lc.int8_leg_sizes(train_config().param_count(), TRAIN_PODS)
    quant, dequant = [], []
    for n, label, iters in ((leg1, f"train leg 1 N={leg1}", 3),
                            (leg2, f"train leg 2 N={leg2}", 5),
                            (1024, "N=1024", 200), (1 << 16, "N=2^16", 200),
                            (1 << 24, "N=2^24", 20)):
        qr, dr = check_qsr(dev, n, label, iters)
        quant.append(qr)
        dequant.append(dr)
        torch.cuda.empty_cache()
    lap("qsr")
    out = {"phase": "kernel_check", "library_ms": None, "section_s": section_s,
           "monitor_tick": monitor, "route_arrivals": route,
           "route_arrivals_cases": route_cases, "decide": decide_timed,
           "decide_cases": decide_cases,
           "cong_update": cong, "lcmp_decide": decide,
           "qsr_int8": quant, "qsr_dequant": dequant,
           "qsr_unbiased_max_err": qsr_unbiased(dev),
           "lcmp_decide_refuses_p9": refuses_wide_sets(dev)}
    emit(out)
    require(out["lcmp_decide_refuses_p9"], "lcmp_decide raises on P > 8")
    require(out["qsr_unbiased_max_err"] <= 2e-3, "qsr: stochastic rounding unbiased")
    return out


class PlainCalls:
    """Counts calls of the kernels' plain versions, every function that
    ``kernels.ref`` defines, while active, so a run can show that none ran
    on the card's path."""

    def __enter__(self):
        from repro_torch.kernels import ref
        self.ref, self.saved, self.called = ref, {}, collections.Counter()
        for name, fn in list(vars(ref).items()):
            if inspect.isfunction(fn) and fn.__module__ == ref.__name__:
                self.saved[name] = fn
                setattr(ref, name, self._counting(name, fn))
        return self

    @property
    def calls(self) -> int:
        return sum(self.called.values())

    def _counting(self, name, fn):
        def counted(*a, **kw):
            self.called[name] += 1
            return fn(*a, **kw)
        return counted

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ref, name, fn)


def expected_decides(cfg) -> int:
    """``decide`` launches a run makes: one per trip step, and while the
    re-decision plane is armed one per epoch (fluid) or one per slot
    (packet: flowlet eligibility is checked every slot)."""
    from repro_torch.netsim import engine
    T = cfg.num_steps
    trips = {at // cfg.dt_us for _, at in cfg.fail_sched}
    if cfg.fail_link >= 0:
        trips.add(cfg.fail_at_us // cfg.dt_us)
    epochs = 0
    if engine.wants_redecide(cfg):
        epoch = (1 if cfg.engine == "packet"
                 else max(cfg.redecide_period_us // cfg.dt_us, 1))
        epochs = -(-T // epoch)
    return len({s for s in trips if 0 <= s < T}) + epochs


def run_main_path(dev, name: str) -> dict:
    """One run of ``RUNS`` or ``PACKET_RUNS`` through ``run_experiment``
    on the card, held to its reference number and its launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.netsim import engine
    from repro_torch.netsim import experiment as pexp
    spec = pexp.ExpSpec(**{**RUNS, **PACKET_RUNS}[name])
    reference = {**REFERENCE, **PACKET_REFERENCE}[name]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    with PlainCalls() as plain:
        t0 = time.perf_counter()
        stats, util, (_, _, flows, cfg, final) = pexp.run_experiment(spec,
                                                                     device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = ops.counts()
    decides = expected_decides(cfg)
    out = {"phase": "run" if spec.engine == "fluid" else "packet",
           "run": name, "engine": spec.engine, "policy": spec.policy,
           "cc": spec.cc, "p50": stats.p50, "p99": stats.p99,
           "completed": stats.completed, "offered": stats.offered,
           "steps": cfg.num_steps, "wall_s": wall,
           "steps_per_s": cfg.num_steps / wall,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": counts, "expected_decide": decides,
           "plain_calls": plain.calls, "reference": reference}
    if engine.wants_redecide(cfg):
        out["route_nonce_max"] = int(final.route_nonce.max())
    emit(out)
    require(counts["monitor_tick"] == cfg.num_steps,
            f"{name}: one monitor_tick launch per step")
    require(counts["route_arrivals"] == cfg.num_steps,
            f"{name}: one route_arrivals launch per step")
    require(counts["decide"] == decides,
            f"{name}: one decide launch per trip step and epoch or armed slot")
    require(counts["cong_update"] == counts["lcmp_decide"] == 0,
            f"{name}: the standalone entries are not on the path")
    require(plain.calls == 0, f"{name}: no plain version ran on the card")
    require(np.isfinite(stats.slowdown).all() and (stats.slowdown >= 1).all(),
            f"{name}: finite slowdowns")
    require(np.isfinite(util).all(), f"{name}: finite utilization")
    require(bool(torch.isfinite(final.q_bytes).all()), f"{name}: finite queues")
    if spec.engine == "packet":
        require(bool((final.fq >= 0).all()) and float(final.hist_q.max())
                <= cfg.buffer_bytes * cfg.cap_scale,
                f"{name}: hop queues non-negative, queues inside the buffer")
    r50, r99, rdone, roffered = reference
    parents = int(flows.subflow_of.max()) + 1 if flows.subflow_of is not None \
        else flows.num_flows
    require(stats.offered == roffered == parents,
            f"{name}: offered flows equal the reference's")
    require(within(stats.p50, r50, P50_BAND), f"{name}: p50 in band")
    require(within(stats.p99, r99, P99_BAND), f"{name}: p99 in band")
    require(abs(stats.completed - rdone) <= COMPLETED_BAND * roffered,
            f"{name}: completed in band")
    return out


def phase_runs(dev, names=ALONE) -> dict:
    """Every run of ``names`` (``run_main_path``)."""
    return {name: run_main_path(dev, name) for name in names}


def phase_packet(dev) -> dict:
    return phase_runs(dev, PACKET_ALONE)


def check_orderings(runs: dict, groups: dict, every: dict, orderings) -> None:
    """Every run of ``every`` was driven, alone (``runs``) or as a cell of
    one of ``groups`` (their rows' ``run``), and the reference's
    ``orderings`` hold on those numbers."""
    numbers = {row["run"]: row for g in groups.values()
               for row in g["per_cell"] if row.get("run")}
    numbers.update(runs)
    require(set(every) <= set(numbers), "every run was driven alone or in a "
            f"group (missing {sorted(set(every) - set(numbers))})")
    for a, b, stat in orderings:
        require(numbers[a][stat] < numbers[b][stat], f"{stat}: {a} < {b}")


def agree(a, b) -> bool:
    """Two card runs of one cell agree to the printed digits (4
    significant digits of p50 and p99, the same completions): the packet
    step's index_add_ sums in a varying order, which can move p99's
    seventh digit (the fluid step's offered load is summed in float64,
    where the order does not show)."""
    return (abs(a.p50 - b.p50) <= 5e-4 * abs(b.p50)
            and abs(a.p99 - b.p99) <= 5e-4 * abs(b.p99)
            and a.completed == b.completed)


def run_sweep_group(dev, group: str, runs: dict) -> dict:
    """One group of ``SWEEPS`` through ``run_sweep`` on the card: one
    ``monitor_tick`` and one ``route_arrivals`` launch a step for the
    whole group, ``expected_decides`` ``decide`` launches, no standalone
    entry and no plain version; each cell within the bands of its
    reference number (``REFERENCE`` or ``SWEEP_REFERENCE``), and each cell
    that phase run ran alone agreeing with that run to the printed digits
    (the CPU tests hold every merged cell to its sequential run bit for
    bit). The batched wall time stands beside the sum of phase run's times
    for the cells it ran."""
    from repro_torch.kernels import ops
    from repro_torch.netsim import engine
    from repro_torch.netsim import experiment as pexp
    from repro_torch.netsim import sweep
    cells = sweep_cells(group)
    specs = [pexp.ExpSpec(**kw) for _, kw, _ in cells]
    _, cfg = sweep.group_config(specs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    with PlainCalls() as plain:
        t0 = time.perf_counter()
        rep = sweep.run_sweep(specs, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = ops.counts()
    peak = torch.cuda.max_memory_allocated()
    decides = expected_decides(cfg)

    in_run = [run for _, _, run in cells if run in runs]
    rows = []
    for (name, kw, run), res in zip(cells, rep.results):
        st = res.stats
        ref_nums = REFERENCE[run] if run else SWEEP_REFERENCE[name]
        row = {"cell": name, "p50": st.p50, "p99": st.p99,
               "completed": st.completed, "offered": st.offered,
               "reference": ref_nums, "run": run,
               "route_nonce_max": int(res.final.route_nonce.max())}
        if run in runs:
            alone = SimpleNamespace(**{k: runs[run][k] for k in
                                       ("p50", "p99", "completed")})
            row.update({"run_alone": run,
                        "run_alone_p50_p99_completed": [
                            alone.p50, alone.p99, alone.completed],
                        "agrees_with_run_alone": agree(st, alone)})
        rows.append(row)
    out = {"phase": "sweep", "group": group, "cells": len(cells),
           "groups": rep.num_groups, "steps": cfg.num_steps,
           "sweep_policies": list(cfg.sweep_policies), "wall_s": wall,
           "cells_run_alone": len(in_run),
           "run_alone_wall_s": sum(runs[r]["wall_s"] for r in in_run),
           "max_memory_allocated": peak, "launches": counts,
           "expected_decide": decides, "plain_calls": plain.calls,
           "per_cell": rows}
    emit(out)
    out["finals"] = [res.final for res in rep.results]     # sweep_mesh's
    require(rep.num_groups == 1, f"sweep {group}: one static group")
    require(counts["monitor_tick"] == cfg.num_steps
            and counts["route_arrivals"] == cfg.num_steps,
            f"sweep {group}: one monitor_tick and one route_arrivals launch a "
            "step for the whole group")
    require(counts["decide"] == decides,
            f"sweep {group}: one decide launch per trip step and epoch")
    require(counts["cong_update"] == counts["lcmp_decide"] == 0,
            f"sweep {group}: the standalone entries are not on the path")
    require(plain.calls == 0, f"sweep {group}: no plain version ran on the card")
    redecides = engine.wants_redecide(cfg)
    for (name, _, _), res, row in zip(cells, rep.results, rows):
        st, (r50, r99, rdone, roffered) = res.stats, row["reference"]
        require(np.isfinite(st.slowdown).all() and (st.slowdown >= 1).all()
                and np.isfinite(res.util).all(), f"{name}: finite results")
        require(st.offered == roffered, f"{name}: offered flows equal the "
                "reference's")
        require(within(st.p50, r50, P50_BAND), f"{name}: p50 in band")
        require(within(st.p99, r99, P99_BAND), f"{name}: p99 in band")
        require(abs(st.completed - rdone) <= COMPLETED_BAND * roffered,
                f"{name}: completed in band")
        require(row.get("agrees_with_run_alone", True), f"{name}: the "
                "batched cell agrees with its run alone to the printed digits")
        moves = redecides and res.spec.policy in engine.REDECIDE_POLICIES
        require((row["route_nonce_max"] > 0) == moves, f"{name}: only "
                "re-deciding cells re-decide (the others keep nonce 0)")
    if group == "fig5":
        for load in {kw["load"] for _, kw, _ in cells}:
            p99 = {kw["policy"]: row["p99"] for (_, kw, _), row in
                   zip(cells, rows) if kw["load"] == load}
            require(p99["lcmp"] < p99["ecmp"], f"fig5 load {load}: p99 lcmp "
                    "< ecmp")
    return out


def offered_load_probe(dev, steps: int = 500, reps: int = 50) -> dict:
    """What the merged fig5 step's offered-load sum costs: after ``steps``
    steps, the step's own sum (``index_add_`` in float64, each masked 0.0
    contribution parked on its own slot) against a float32 sum with the
    0.0 contributions of unrouted and finished flows and of short paths'
    pad hops all sent to link 0 (the step's earlier layout) and the float32
    sum of the nonzero contributions alone, each timed over ``reps`` calls
    with CUDA events. All three agree within float32 rounding, and the
    step's sum is the same in every call (its atomics' order does not
    show)."""
    from repro_torch.netsim import experiment as pexp
    from repro_torch.netsim import fluid, sweep
    g = sweep.build_group([pexp.ExpSpec(**kw) for kw in SWEEPS["fig5"]],
                          device=dev)
    step, st = fluid.make_step(g.arrs, g.cfg), g.state
    for t in range(steps):
        st = step(st, t)
    pf = st.flow_path
    links_f = g.arrs.path_links[torch.clamp_min(pf, 0)]
    links_ok = ((links_f >= 0) & st.active[:, None]
                & (pf >= 0)[:, None]).reshape(-1)
    lidx = torch.clamp_min(links_f, 0).reshape(-1)
    contrib = torch.where(links_ok, st.rate.repeat_interleave(
        links_f.shape[1]), 0.0)
    L, n = g.arrs.link_cap.shape[0], lidx.numel()
    park = torch.where(links_ok, lidx, L + torch.arange(n, device=dev))
    out = {"phase": "offered_load_probe",
           "spec": f"fig5 merged sweep ({len(g.specs)} cells), step {steps}",
           "contributions": n, "nonzero": int(links_ok.sum()),
           "most_on_one_link": int(torch.bincount(lidx, minlength=L).max()),
           "most_nonzero_on_one_link": int(torch.bincount(
               lidx[links_ok], minlength=L).max())}
    sums, same = {}, True
    for name, (i, v, size) in {
            "step": (park, contrib.double(), L + n),
            "link0": (lidx, contrib, L),
            "nonzero": (lidx[links_ok], contrib[links_ok], L)}.items():
        def total():
            return torch.zeros(size, dtype=v.dtype, device=dev).index_add_(
                0, i, v)[:L].float()
        for _ in range(5):
            total()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(reps):
            total()
        t1.record()
        torch.cuda.synchronize()
        out[f"{name}_us"] = t0.elapsed_time(t1) / reps * 1e3
        sums[name] = total()
        if name == "step":
            same = all(torch.equal(total(), sums[name]) for _ in range(reps))
    out["max_abs_diff"] = max(float((sums["step"] - sums[k]).abs().max())
                              for k in ("link0", "nonzero"))
    out["step_sum_same_every_call"] = same
    emit(out)
    require(all(torch.allclose(sums["step"], sums[k], rtol=1e-5, atol=0.0)
                for k in ("link0", "nonzero")),
            "offered_load_probe: the three sums agree")
    require(same, "offered_load_probe: the step's sum is the same every call")
    return out


def phase_sweep(dev, runs: dict) -> dict:
    """Every group of ``SWEEPS`` (``run_sweep_group``) and the reference's
    ``ORDERINGS``, then where a step of the merged fig5 world spends its
    time (``profile_steps``) and what its offered-load sum costs
    (``offered_load_probe``)."""
    from repro_torch.netsim import experiment as pexp
    from repro_torch.netsim import sweep
    groups = {g: run_sweep_group(dev, g, runs) for g in SWEEPS}
    check_orderings(runs, groups, RUNS, ORDERINGS)
    g = sweep.build_group([pexp.ExpSpec(**kw) for kw in SWEEPS["fig5"]],
                          device=dev)
    profile_steps(g.arrs, g.state, g.cfg, f"fig5 merged sweep ({len(g.specs)} "
                  "cells), from step 300", phase="sweep_profile")
    del g
    offered_load_probe(dev)
    return groups


def forbid_plain() -> None:
    """Phase sweep_mesh's worker set-up: every plain version that
    ``kernels.ref`` defines raises, so a worker that runs one fails the
    phase (``PlainCalls`` counts them in this process)."""
    from repro_torch.kernels import ref

    def refusing(name):
        def refuse(*_, **__):
            raise RuntimeError(f"plain version {name} ran in a sweep worker")
        return refuse
    for name, fn in list(vars(ref).items()):
        if inspect.isfunction(fn) and fn.__module__ == ref.__name__:
            setattr(ref, name, refusing(name))


def same_final(a, b) -> bool:
    return all(np.array_equal(getattr(a, n), getattr(b, n))
               for n in SWEEP_FINAL)


def start_mesh_workers(dev):
    """Phase sweep_mesh's ``MESH_WORKERS`` worker processes on ``dev``
    (``forbid_plain`` set up in each), started before phase sweep so that
    their start-up (an interpreter, torch and a CUDA context each)
    overlaps it."""
    from repro_torch.netsim import sweep
    return sweep.SweepWorkers([dev] * MESH_WORKERS,
                              initializer=(forbid_plain, ()))


def phase_sweep_mesh(dev, sweeps: dict, workers) -> dict:
    """``run_sweep(use_mesh=True)`` on one card: each group of
    ``MESH_GROUPS`` through its runner (``sweep.run_sharded``) on
    ``workers`` (``start_mesh_workers``), so its cells split into
    ``MESH_WORKERS`` shards, each a merged world in a worker process of
    its own. Every cell's final state must equal phase sweep's merged
    run of the same cell bit for bit (both engines sum per link in
    float64 on the card, so a cell's numbers do not depend on which
    cells share its world); where one does not, the merged group is run
    again here, to tell an engine that does not repeat itself from a
    split that changes numbers. The workers' launches, added to this
    process's counts: one ``monitor_tick`` and one ``route_arrivals`` a
    step per non-empty shard, and each shard's ``expected_decides`` (a
    shard's configuration keeps only its own cells' laws, so a shard
    with no re-deciding cell makes no epoch ``decide``); no standalone
    entry. Each worker's start-up and peak memory, and each group's
    sharded wall beside phase sweep's merged one."""
    from repro_torch.kernels import ops
    from repro_torch.netsim import experiment as pexp
    from repro_torch.netsim import sweep
    ops.reset_counts()
    want, rows, differ, reps = collections.Counter(), {}, [], []
    for g in MESH_GROUPS:
        cells = sweep_cells(g)
        specs = [pexp.ExpSpec(**kw) for _, kw, _ in cells]
        shards = [s.tolist() for s in np.array_split(
            np.arange(len(specs)), len(workers.devices)) if len(s)]
        for shard in shards:
            _, cfg = sweep.group_config([specs[i] for i in shard])
            want["monitor_tick"] += cfg.num_steps
            want["route_arrivals"] += cfg.num_steps
            want["decide"] += expected_decides(cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = sweep.run_sharded(specs, workers=workers)
        wall = time.perf_counter() - t0
        reps.append(rep)
        bad = [name for (name, _, _), res, m in
               zip(cells, rep.results, sweeps[g]["finals"])
               if not same_final(res.final, m)]
        rows[g] = {"cells": len(specs), "shards": [len(s) for s in shards],
                   "group_cells": rep.group_cells, "wall_s": wall,
                   "merged_wall_s": sweeps[g]["wall_s"], "differ": bad}
        if bad:     # does the merged run repeat itself on the card?
            rerun = sweep.run_sweep(specs, device=dev)
            rows[g]["merged_repeats"] = all(
                same_final(r.final, m)
                for r, m in zip(rerun.results, sweeps[g]["finals"]))
        differ += bad
    counts = ops.counts()
    stats = reps[-1].workers            # the workers' totals since start
    out = {"phase": "sweep_mesh",
           "devices": [str(d) for d in workers.devices],
           "groups": rows, "cells": sum(r["cells"] for r in rows.values()),
           "wall_s": sum(r["wall_s"] for r in rows.values()),
           "merged_wall_s": sum(r["merged_wall_s"] for r in rows.values()),
           "startup_s": [w["startup_s"] for w in stats],
           "startup": "overlapped phase sweep",
           "workers": stats, "launches": counts,
           "expected_launches": dict(want),
           "plain_versions": "raise in the workers (forbid_plain)",
           "bit_for_bit": not differ, "differ": differ}
    emit(out)
    for g, row in rows.items():
        require(row["group_cells"] == [len(SWEEPS[g])],
                f"sweep_mesh {g}: group_cells as unsharded")
    require(len(stats) == MESH_WORKERS
            and all(w["device"] == str(dev) for w in stats),
            f"sweep_mesh: {MESH_WORKERS} workers on {dev}")
    require(all(sum(w["launches"][n] for w in stats) == counts[n]
                for n in counts), "sweep_mesh: this process's counts are "
            "the workers' launches")
    require(not differ, "sweep_mesh: every cell equals phase sweep's merged "
            f"run bit for bit (differ: {differ})")
    for name in ("monitor_tick", "route_arrivals", "decide"):
        require(counts[name] == want[name], f"sweep_mesh: {name} launched "
                f"{counts[name]} times, {want[name]} expected")
    require(counts["cong_update"] == counts["lcmp_decide"] == 0,
            "sweep_mesh: the standalone entries are not on the path")
    return out


def fidelity_grid(dev, grid: str, packet_runs: dict) -> dict:
    """One fidelity grid (``fidelity_cells``) through one ``run_sweep`` on
    the card: one ``monitor_tick`` and one ``route_arrivals`` launch a
    step for each of its four groups, no ``decide``, no standalone entry,
    no plain version; each cell within the bands of its reference number
    (``PACKET_REFERENCE`` or ``FIDELITY_REFERENCE``), and each cell that
    phase packet ran alone agreeing with that run to the printed digits
    (phase sweep does the same for fluid cells, and the CPU tests hold
    every merged cell bit for bit); the log-space Pearson r
    of packet against fluid within ``PEARSON_BAND`` of the reference's;
    LCMP below ECMP in p50 and p99 on testbed8 under both engines."""
    from repro_torch.kernels import ops
    from repro_torch.netsim import experiment as pexp
    from repro_torch.netsim import sweep
    cells = fidelity_cells(grid)
    specs = [pexp.ExpSpec(**kw) for _, kw, _ in cells]
    keys = {}
    for spec in specs:
        keys.setdefault(sweep.static_key(spec), []).append(spec)
    cfgs = [sweep.group_config(g, key)[1] for key, g in keys.items()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    with PlainCalls() as plain:
        t0 = time.perf_counter()
        rep = sweep.run_sweep(specs, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = ops.counts()
    peak = torch.cuda.max_memory_allocated()
    steps = sum(c.num_steps for c in cfgs)
    decides = sum(expected_decides(c) for c in cfgs)

    rows, by = [], {}
    for (name, kw, run), res in zip(cells, rep.results):
        st = res.stats
        row = {"cell": name, "p50": st.p50, "p99": st.p99,
               "completed": st.completed, "offered": st.offered,
               "reference": PACKET_REFERENCE[run] if run
               else FIDELITY_REFERENCE[name], "run": run}
        if run in packet_runs:
            alone = SimpleNamespace(**{k: packet_runs[run][k]
                                       for k in ("p50", "p99", "completed")})
            row.update({"run_alone": run,
                        "run_alone_p50_p99_completed": [
                            alone.p50, alone.p99, alone.completed],
                        "agrees_with_run_alone": agree(st, alone)})
        rows.append(row)
        by[(name.split("/")[1], kw["policy"], kw["engine"])] = st
    fl, pk = [], []
    for scen in FIDELITY_LOADS:
        for pol in FIDELITY_POLICIES:
            a, b = by[(scen, pol, "fluid")], by[(scen, pol, "packet")]
            fl += [a.p50, a.p99]
            pk += [b.p50, b.p99]
    r = log_pearson(fl, pk)
    t8 = {(pol, eng): by[("testbed8", pol, eng)] for pol in ("lcmp", "ecmp")
          for eng in ("fluid", "packet")}
    ordered = {eng: t8[("lcmp", eng)].p50 < t8[("ecmp", eng)].p50
               and t8[("lcmp", eng)].p99 < t8[("ecmp", eng)].p99
               for eng in ("fluid", "packet")}
    out = {"phase": "packet_sweep", "grid": grid, "cells": len(cells),
           "groups": rep.num_groups, "group_cells": rep.group_cells,
           "steps": steps, "wall_s": wall, "max_memory_allocated": peak,
           "launches": counts, "expected_decide": decides,
           "plain_calls": plain.calls, "pearson_log": r,
           "reference_pearson_log": FIDELITY_PEARSON[grid],
           "meets_paper_bar": r >= PAPER_PEARSON,
           "lcmp_beats_ecmp_both_engines": ordered, "per_cell": rows}
    emit(out)
    require(rep.num_groups == 4, f"{grid}: one group per scenario and engine")
    require(counts["monitor_tick"] == steps and counts["route_arrivals"] == steps,
            f"{grid}: one monitor_tick and one route_arrivals launch a step "
            "for each group")
    require(counts["decide"] == decides, f"{grid}: no decide launch")
    require(counts["cong_update"] == counts["lcmp_decide"] == 0,
            f"{grid}: the standalone entries are not on the path")
    require(plain.calls == 0, f"{grid}: no plain version ran on the card")
    for row, res in zip(rows, rep.results):
        name, st, (r50, r99, rdone, roffered) = row["cell"], res.stats, \
            row["reference"]
        require(np.isfinite(st.slowdown).all() and (st.slowdown >= 1).all()
                and np.isfinite(res.util).all(), f"{name}: finite results")
        require(st.offered == roffered, f"{name}: offered flows equal the "
                "reference's")
        require(within(st.p50, r50, P50_BAND), f"{name}: p50 in band")
        require(within(st.p99, r99, P99_BAND), f"{name}: p99 in band")
        require(abs(st.completed - rdone) <= COMPLETED_BAND * roffered,
                f"{name}: completed in band")
        require(row.get("agrees_with_run_alone", True),
                f"{name}: the batched cell agrees with its run alone to the "
                "printed digits")
    require(abs(r - FIDELITY_PEARSON[grid]) <= PEARSON_BAND,
            f"{grid}: Pearson r {r:.4f} within {PEARSON_BAND} of the "
            f"reference's {FIDELITY_PEARSON[grid]}")
    require((r >= PAPER_PEARSON) == (FIDELITY_PEARSON[grid] >= PAPER_PEARSON),
            f"{grid}: Pearson r on the same side of the paper's bar as the "
            "reference's")
    require(all(ordered.values()), f"{grid}: lcmp below ecmp in p50 and p99 "
            "on testbed8 under both engines")
    return out


def phase_packet_sweep(dev, packet_runs: dict) -> dict:
    """fidelity_bench's grid at its default and quick scales
    (``fidelity_grid``), then the reference's ``PACKET_ORDERINGS``."""
    grids = {grid: fidelity_grid(dev, grid, packet_runs)
             for grid in FIDELITY_DURATION}
    check_orderings(packet_runs, grids, PACKET_RUNS, PACKET_ORDERINGS)
    return grids


def mutations():
    """The seeded-bug corpus of the CPU tests (``tests/torch_mutations.py``)."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    try:
        import torch_mutations
    finally:
        sys.path.remove(os.path.join(HERE, "tests"))
    return torch_mutations.MUTATIONS


def state_tensors(st) -> dict:
    """Every tensor of an engine state by name, the registers flattened."""
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v
        else:
            out.update({f"{f.name}.{g.name}": getattr(v, g.name)
                        for g in dataclasses.fields(v)})
    return out


def sanitize_run(dev, engine_name: str, checks: bool, mutation=None,
                 sync_check: bool = False, steps: int | None = None):
    """One run at ``SANITIZE`` through the engine's step, its first
    ``steps`` steps (default all); returns
    ``(final state, first invariant error or None, syncs at the end)``.
    With ``sync_check`` steps 1.. run under
    ``torch.cuda.set_sync_debug_mode("error")`` (step 0 builds the run's
    launchers, whose set-up checks read index ranges back) and the
    checked run's final read counts its synchronizing calls."""
    from repro_torch.netsim import engine, sanitize
    from repro_torch.netsim import experiment as pexp
    spec = pexp.ExpSpec(engine=engine_name, checks=int(checks), **SANITIZE)
    _, table, flows, cfg = pexp.build_experiment(spec)
    mod = engine.get_engine(engine_name)
    arrs, st = mod.build(table, flows, cfg, device=dev)
    sanitize._MUTATION = mutation
    err, syncs = None, None
    try:
        with torch.inference_mode():
            step = mod.make_step(arrs, cfg)
            st = step(st, 0)
            torch.cuda.synchronize()
            if sync_check:
                torch.cuda.set_sync_debug_mode("error")
            try:
                for t in range(1, steps or cfg.num_steps):
                    st = step(st, t)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            if step.checker is not None:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        step.checker.throw()
                    except sanitize.InvariantError as e:
                        err = e
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                syncs = sum("synchroniz" in str(w.message) for w in caught)
    finally:
        sanitize._MUTATION = None
    torch.cuda.synchronize()
    return st, err, syncs


def phase_sanitize(dev) -> dict:
    """Phase sanitize (see the module docstring)."""
    from repro_torch.netsim import engine, packet, sanitize
    from repro_torch.netsim import experiment as pexp
    out = {"phase": "sanitize", "spec": SANITIZE}
    for eng in ("fluid", "packet"):
        t0 = time.perf_counter()
        on, err, syncs = sanitize_run(dev, eng, True, sync_check=True)
        t1 = time.perf_counter()
        off, _, _ = sanitize_run(dev, eng, False, sync_check=True)
        t2 = time.perf_counter()
        a, b = state_tensors(on), state_tensors(off)
        differ = [n for n in a if not torch.equal(a[n], b[n])]
        out[eng] = {"checked_error": None if err is None else str(err),
                    "state_fields": len(a), "fields_differing": differ,
                    "syncs_at_end": syncs, "steps_without_sync": True,
                    "checked_wall_s": t1 - t0, "unchecked_wall_s": t2 - t1}
    caught = {}
    for eng in ("fluid", "packet"):
        for name, fn in mutations().items():
            _, err, _ = sanitize_run(dev, eng, True, mutation=fn,
                                     steps=MUTATION_STEPS)
            caught[f"{eng}/{name}"] = None if err is None else err.invariant
        # signal_causality: signal delays that would read the future
        spec = pexp.ExpSpec(engine=eng, checks=1, **SANITIZE)
        _, table, flows, cfg = pexp.build_experiment(spec)
        mod = engine.get_engine(eng)
        arrs, st = mod.build(table, flows, cfg, device=dev)
        arrs = dataclasses.replace(arrs,
                                   path_sig_delay=-(arrs.path_sig_delay + 1))
        try:
            mod.run(arrs, st, cfg)
            caught[f"{eng}/signal_causality"] = None
        except sanitize.InvariantError as e:
            caught[f"{eng}/signal_causality"] = e.invariant
    # pfc_lossless: all pairs into a 2e5-byte buffer, where pauses fire
    spec = pexp.ExpSpec(engine="packet", pairs="all", checks=1, **SANITIZE)
    _, table, flows, cfg = pexp.build_experiment(spec)
    cfg = dataclasses.replace(cfg, buffer_bytes=2e5)
    arrs, st = packet.build(table, flows, cfg, device=dev)
    final = packet.run(arrs, st, cfg)
    paused = int(final.hist_pause.sum())
    gate = sanitize.pfc_gate
    sanitize.pfc_gate = lambda okh, paused_next: okh
    try:
        arrs, st = packet.build(table, flows, cfg, device=dev)
        packet.run(arrs, st, cfg)
        caught["packet/pfc_lossless"] = None
    except sanitize.InvariantError as e:
        caught["packet/pfc_lossless"] = e.invariant
    finally:
        sanitize.pfc_gate = gate
    out["caught"] = caught
    out["pfc_paused_link_slots"] = paused
    emit(out)
    for eng in ("fluid", "packet"):
        r = out[eng]
        require(r["checked_error"] is None,
                f"sanitize {eng}: a clean checked run passes")
        require(not r["fields_differing"], f"sanitize {eng}: checked state "
                "equals unchecked bit for bit")
        require(r["syncs_at_end"] is not None and r["syncs_at_end"] <= 1,
                f"sanitize {eng}: the checked run reads its checks once")
    for key, got in caught.items():
        require(got == key.split("/")[1], f"sanitize: {key} fires under its "
                f"own name (got {got})")
    require(paused > 0, "sanitize: PFC pauses fire in the pfc_lossless run")
    return out


def phase_cosim(dev) -> dict:
    """Phase cosim (see the module docstring)."""
    from repro_torch import cosim
    from repro_torch.kernels import ops
    from repro_torch.netsim import experiment as pexp
    from repro_torch.netsim import sweep
    cells = cosim_cells()
    specs = [pexp.ExpSpec(**kw) for _, kw in cells]
    steps = {s.engine: sweep.static_key(s)[1].num_steps for s in specs}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    with PlainCalls() as plain:
        t0 = time.perf_counter()
        rep = sweep.run_sweep(specs, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = ops.counts()
    scen, table = pexp.build_world(COSIM["topology"])
    numbers, rows = {}, []
    for (name, kw), res in zip(cells, rep.results):
        plan = cosim.build_plan(res.spec, scen, table)
        it = cosim.iteration_stats(plan, res.flows, res.final)
        st = res.stats
        numbers[name] = (it.pct_strict(50), it.pct_strict(99), it.iters_done,
                         st.completed, st.offered)
        rows.append({"cell": name, "iter_p50_ms": it.pct_strict(50),
                     "iter_p99_ms": it.pct_strict(99),
                     "iters_done": it.iters_done,
                     "makespan_ms": it.makespan_ms.tolist(),
                     "p50": st.p50, "p99": st.p99, "completed": st.completed,
                     "offered": st.offered, "cosim_rows": plan.num_rows,
                     "reference": COSIM_REFERENCE[name]})
    flags = cosim_orderings(numbers)
    out = {"phase": "cosim", "cells": len(cells), "groups": rep.num_groups,
           "group_cells": rep.group_cells, "steps": steps, "wall_s": wall,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": counts, "plain_calls": plain.calls,
           "orderings": {f"{e}/{m}": v for (e, m), v in flags.items()},
           "per_cell": rows}
    emit(out)
    require(rep.num_groups == 2, "cosim: one merged group per engine")
    total = sum(steps.values())
    require(counts["monitor_tick"] == counts["route_arrivals"] == total,
            "cosim: one monitor_tick and one route_arrivals launch a step "
            "per group")
    require(counts["decide"] == 0, "cosim: no trip, epoch or flowlet gap, so "
            "no decide")
    require(counts["cong_update"] == counts["lcmp_decide"] == 0,
            "cosim: the standalone entries are not on the path")
    require(plain.calls == 0, "cosim: no plain version ran on the card")

    def close(got, want, band):
        if math.isinf(want) or math.isinf(got):
            return math.isinf(want) and math.isinf(got)
        return within(got, want, band)
    for name, (p50, p99, iters, done, offered) in numbers.items():
        r50, r99, riters, rdone, roffered = COSIM_REFERENCE[name]
        require(close(p50, r50, P50_BAND), f"{name}: iteration p50 in band")
        require(close(p99, r99, P99_BAND), f"{name}: iteration p99 in band")
        require(iters == riters, f"{name}: iterations done equal")
        require(offered == roffered, f"{name}: offered flows equal")
        require(abs(done - rdone) <= COMPLETED_BAND * roffered,
                f"{name}: completed in band")
    require(flags == COSIM_ORDERING, "cosim: each LCMP ordering flag equals "
            "the reference's")
    return out


def switch_inputs(dev):
    """Phase switch's tables and per-tick inputs, made from its seed."""
    from repro_torch.core import tables
    rng = np.random.default_rng(SWITCH["seed"])
    P, C, n = SWITCH["ports"], SWITCH["cands"], SWITCH["batch"]
    rates = [int(x) for x in rng.choice([40, 100, 200, 400], P)]
    cport = rng.choice(P, C, replace=False)
    delays = rng.choice([5_000, 8_000, 12_000, 40_000], C)
    caps = rng.choice([100, 200, 400], C)
    # queue cells: random walks inside the 6 GB buffer
    steps = rng.integers(-600_000, 700_000, (SWITCH["ticks"], P))
    queues = np.clip(np.cumsum(steps, 0), 0, 5_800_000).astype(np.int32)
    flows, seen = [], np.zeros(0, np.uint32)
    for tick in range(SWITCH["ticks"]):
        fresh = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        if len(seen):                # half of a batch established flows
            fresh[: n // 2] = rng.choice(seen[-8 * n:], n // 2)
        flows.append(fresh.astype(np.int64))
        seen = np.concatenate([seen, fresh[n // 2:]])
    return (tables.bootstrap_tables(rates, buffer_bytes=6 * 10**9, device=dev),
            delays, caps, cport, torch.tensor(queues, device=dev),
            torch.tensor(np.stack(flows), device=dev))


def switch_run(dev, inputs, timed: bool = False) -> dict:
    """Phase switch's 200 ticks through ``core.switchd``; returns the
    choices, new-flow flags, final switch and (``timed``) the synchronized
    host µs of each ``route_batch``."""
    from repro_torch.core import switchd
    tb, delays, caps, cport, queues, flows = inputs
    params = switchd.SwitchParams(idle_timeout_us=SWITCH["idle_timeout_us"])
    sw = switchd.make_switch(tb, delays, caps, cport, SWITCH["ports"],
                             SWITCH["capacity"], params, device=dev)
    dead = int(cport[int(torch.argmin(sw.c_path))])
    choices, news, us = [], [], []
    for tick in range(SWITCH["ticks"]):
        now = tick * 100
        if tick == SWITCH["dead_tick"]:
            alive = torch.ones(SWITCH["ports"], dtype=torch.bool, device=dev)
            alive[dead] = False
            sw = switchd.set_port_liveness(sw, alive)
        sw = switchd.monitor_tick(sw, queues[tick], now, params)
        if timed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        sw, idx, new = switchd.route_batch(sw, flows[tick], now, params)
        if timed:
            torch.cuda.synchronize()
            us.append(1e6 * (time.perf_counter() - t0))
        if tick % SWITCH["gc_every"] == SWITCH["gc_every"] - 1:
            sw = switchd.gc_tick(sw, now, params)
        choices.append(idx)
        news.append(new)
    return {"choice": torch.stack(choices), "is_new": torch.stack(news),
            "switch": sw, "dead_port": dead, "route_us": us}


def phase_switch(dev) -> dict:
    """Phase switch (see the module docstring)."""
    from repro_torch.core import flowcache as fc
    from repro_torch.core import switchd, tables
    from repro_torch.kernels import ops, ref
    inputs = switch_inputs(dev)
    ops.reset_counts()
    with PlainCalls() as plain:
        got = switch_run(dev, inputs, timed=True)
        torch.cuda.synchronize()
    counts = ops.counts()
    # the same run through the plain versions, on the card
    kernels = ops.cong_update, ops.lcmp_decide
    ops.cong_update, ops.lcmp_decide = ref.cong_update_ref, ref.lcmp_decide_ref
    try:
        want = switch_run(dev, inputs)
    finally:
        ops.cong_update, ops.lcmp_decide = kernels
    a, b = got["switch"], want["switch"]
    same = {"choice": torch.equal(got["choice"], want["choice"]),
            "is_new": torch.equal(got["is_new"], want["is_new"]),
            "c_cong": torch.equal(a.c_cong, b.c_cong),
            "cong": all(torch.equal(getattr(a.cong, f.name),
                                    getattr(b.cong, f.name))
                        for f in dataclasses.fields(a.cong)),
            "cache": all(torch.equal(getattr(a.cache, f.name),
                                     getattr(b.cache, f.name))
                         for f in dataclasses.fields(a.cache))}
    # a colliding batch: 4,096 lanes over 64 slots, on the card and the CPU
    rng = np.random.default_rng(SWITCH["seed"] + 1)
    ids = torch.tensor(rng.integers(0, 2**32, 4096, dtype=np.uint64)
                       .astype(np.int64))
    outs = torch.tensor(rng.integers(-1, SWITCH["cands"], 4096)
                        .astype(np.int32))
    do = torch.tensor(rng.random(4096) < 0.6)
    caches = {d: fc.insert(fc.FlowCache.init(64, device=d), ids.to(d),
                           outs.to(d), 5, do.to(d)) for d in ("cpu", dev)}
    collide = all(torch.equal(getattr(caches["cpu"], f.name),
                              getattr(caches[dev], f.name).cpu())
                  for f in dataclasses.fields(caches["cpu"]))
    # more than 8 candidates: refused, as the kernel does
    wide = switchd.make_switch(tables.bootstrap_tables([100] * 9, device=dev),
                               [5_000] * 9, [100] * 9, list(range(9)), 9,
                               device=dev)
    try:
        switchd.route_batch(wide, torch.arange(4, device=dev), 0)
        refused = False
    except ValueError:
        refused = True
    us = np.asarray(got["route_us"][1:])
    out = {"phase": "switch", **SWITCH, "dead_port": got["dead_port"],
           "launches": counts, "plain_calls": plain.calls, "equal": same,
           "new_flows": int(got["is_new"].sum()),
           "cache_valid": int(a.cache.valid.sum()),
           "route_batch_us_median": float(np.median(us)),
           "route_batch_us_mean": float(us.mean()),
           "collision_batch_equals_cpu": collide, "wide_set_refused": refused}
    emit(out)
    require(all(same.values()), "switch: the card's run equals the plain "
            "run bit for bit")
    require(counts["cong_update"] == counts["lcmp_decide"] == SWITCH["ticks"],
            "switch: one cong_update and one lcmp_decide launch a tick")
    require(plain.calls == 0, "switch: no plain version ran on the card")
    require(collide, "switch: a colliding batch's cache equals the CPU's")
    require(refused, "switch: more than 8 candidates refused on the card")
    return out


def phase_profile(dev, steps: int = 100) -> list:
    """Where a step's time goes (``profile_steps``): a fluid testbed8
    lcmp step, then a packet slot of fidelity_bench's testbed8 lcmp
    cell."""
    from repro_torch.netsim import engine
    from repro_torch.netsim import experiment as pexp
    out = []
    # a packet slot issues 2.6x the fluid step's kernels: a quarter of the
    # window keeps the profiler's event count (and its host time) alike
    for kw, label, n in ((dict(TESTBED8, policy="lcmp"),
                          "testbed8 lcmp load 0.5, from step 300", steps),
                         (PACKET_RUNS["packet/testbed8/lcmp"],
                          "packet testbed8 lcmp load 0.3 seed 1, from slot 300",
                          steps // 4)):
        _, table, flows, cfg = pexp.build_experiment(pexp.ExpSpec(**kw))
        arrs, st = engine.get_engine(cfg.engine).build(table, flows, cfg,
                                                       device=dev)
        out.append(profile_steps(arrs, st, cfg, label, n))
    return out


def profile_steps(arrs, st, cfg, label: str, steps: int = 100,
                  phase: str = "profile") -> dict:
    """Where a step's time goes in world ``arrs``/``st`` after 300 warm-up
    steps, under ``torch.inference_mode`` as ``run`` steps: the wall time
    of ``steps`` plain steps, then ``steps`` more under
    ``torch.profiler`` for the device-busy time, the idle share, kernels
    per step, the two fused kernels' and ``index_add_``'s device time and
    the kernels that take the most of it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.netsim import engine
    step = engine.get_engine(cfg.engine).make_step(arrs, cfg)
    with torch.inference_mode():
        for t in range(300):
            st = step(st, t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(300, 300 + steps):
            st = step(st, t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for t in range(300 + steps, 300 + 2 * steps):
                st = step(st, t)
            torch.cuda.synchronize()
            wall_prof = time.perf_counter() - t0
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time for e in kern)
    by_name: dict = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    own = {k: sum(v for n, v in by_name.items() if f"{k}_kernel" in n) / steps
           for k in ("monitor_tick", "route_arrivals")}
    # index_add_'s device time: the device time of its op's kernels
    index_add = sum(a.device_time_total if hasattr(a, "device_time_total")
                    else a.cuda_time_total
                    for a in prof.key_averages() if a.key == "aten::index_add_")
    out = {"phase": phase, "spec": label, "engine": cfg.engine,
           "steps": steps, "wall_ms_per_step": wall / steps * 1e3,
           "wall_ms_per_step_profiled": wall_prof / steps * 1e3,
           "device_busy_ms_per_step": busy_us / steps / 1e3,
           # busy time from the profiled steps over the unprofiled wall
           "device_idle_share": 1.0 - busy_us / 1e6 / wall,
           "kernels_per_step": len(kern) / steps,
           "own_kernels_device_us_per_step": own,
           "index_add_device_us_per_step": index_add / steps,
           "top_device_us_per_step": {n[:90]: v / steps for n, v in top}}
    emit(out)
    require(len(kern) > 0, "profile: the step ran kernels on the device")
    require(all(v > 0 for v in own.values()),
            "profile: both fused kernels ran in the step")
    return out


def device_vs_cpu(dev, kw: dict, label: str) -> dict:
    """One 50 ms run on the card and on the CPU (plain versions): the
    same paths for the flows of the first 500 steps, and the same
    p50/p99/completions within the bands."""
    from repro_torch.netsim import experiment as pexp
    spec = pexp.ExpSpec(**dict(kw, duration_us=DEVICE_VS_CPU_US))
    res = {}
    for d in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        stats, _, (_, _, flows, cfg, final) = pexp.run_experiment(spec, device=d)
        if d.type == "cuda":
            torch.cuda.synchronize()
        res[d.type] = (stats, final.flow_path.cpu().numpy(),
                       time.perf_counter() - t0)
    (sg, fg, wg), (sc, fc, wc) = res["cuda"], res["cpu"]
    step = np.minimum(flows.arrival_us // cfg.dt_us, cfg.num_steps - 1)
    early = step < 500
    differ = early & (fg != fc)
    out = {"phase": "device_vs_cpu", "spec": label,
           "same_path_share": float((fg[early] == fc[early]).mean()),
           "flows_first_500_steps": int(early.sum()),
           "first_differing_step": int(step[differ].min()) if differ.any() else None,
           "gpu": {"p50": sg.p50, "p99": sg.p99, "completed": sg.completed,
                   "wall_s": wg},
           "cpu": {"p50": sc.p50, "p99": sc.p99, "completed": sc.completed,
                   "wall_s": wc},
           "offered": sg.offered}
    emit(out)
    require(out["same_path_share"] >= 0.99, f"device vs cpu {label}: same paths")
    require(within(sg.p50, sc.p50, P50_BAND), f"device vs cpu {label}: p50 in band")
    require(within(sg.p99, sc.p99, P99_BAND), f"device vs cpu {label}: p99 in band")
    require(abs(sg.completed - sc.completed) <= COMPLETED_BAND * sg.offered,
            f"device vs cpu {label}: completed in band")
    return out


def sweep_device_vs_cpu(dev, policies=("lcmp", "ecmp", "redte")) -> dict:
    """A 50 ms testbed8 load-0.5 group through ``run_sweep`` on the card
    and on the CPU (plain versions): each cell routes the flows of the
    first 500 steps alike and lands within the bands of the CPU's."""
    from repro_torch.netsim import experiment as pexp
    from repro_torch.netsim import sweep
    specs = [pexp.ExpSpec(**dict(TESTBED8, duration_us=DEVICE_VS_CPU_US, policy=p))
             for p in policies]
    res = []
    for d in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        rep = sweep.run_sweep(specs, device=d)
        if d.type == "cuda":
            torch.cuda.synchronize()
        res.append((rep, time.perf_counter() - t0))
    (g, wg), (c, wc) = res
    cells = []
    for p, a, b in zip(policies, g.results, c.results):
        early = a.flows.arrival_us // 200 < 500
        cells.append({"policy": p,
                      "same_path_share": float((a.final.flow_path[early]
                                                == b.final.flow_path[early]).mean()),
                      "flows_first_500_steps": int(early.sum()),
                      "gpu": [a.stats.p50, a.stats.p99, a.stats.completed],
                      "cpu": [b.stats.p50, b.stats.p99, b.stats.completed]})
    out = {"phase": "device_vs_cpu", "spec": "sweep of testbed8 load 0.5 "
           f"{'/'.join(policies)} 50 ms", "gpu_wall_s": wg, "cpu_wall_s": wc,
           "cells": cells}
    emit(out)
    for row, a, b in zip(cells, g.results, c.results):
        label = f"device vs cpu sweep {row['policy']}"
        require(row["same_path_share"] >= 0.99, f"{label}: same paths")
        require(within(a.stats.p50, b.stats.p50, P50_BAND), f"{label}: p50")
        require(within(a.stats.p99, b.stats.p99, P99_BAND), f"{label}: p99")
        require(abs(a.stats.completed - b.stats.completed)
                <= COMPLETED_BAND * a.stats.offered, f"{label}: completed")
    return out


def phase_device_vs_cpu(dev) -> list:
    """testbed8 lcmp, a schedule run (testbed8_failover lcmp with the
    trip at 25 ms) and a sweep group; then the packet engine:
    fidelity_bench's testbed8 lcmp cell and the same failover (go-back-N
    at the trip)."""
    fail = dict(topology="testbed8_failover:fail_ms=25", load=0.3,
                policy="lcmp")
    return [device_vs_cpu(dev, dict(TESTBED8, policy="lcmp"),
                          "testbed8 lcmp load 0.5 50 ms"),
            device_vs_cpu(dev, fail,
                          "testbed8_failover:fail_ms=25 lcmp load 0.3 50 ms"),
            sweep_device_vs_cpu(dev),
            device_vs_cpu(dev, PACKET_RUNS["packet/testbed8/lcmp"],
                          "packet testbed8 lcmp load 0.3 seed 1 50 ms"),
            device_vs_cpu(dev, dict(fail, engine="packet"),
                          "packet testbed8_failover:fail_ms=25 lcmp load 0.3 "
                          "50 ms")]


def adam_bound(cfg, t: int) -> float:
    """A bound on |m_hat / (sqrt(v_hat) + eps)| after t AdamW steps,
    whatever the gradients: by Cauchy-Schwarz, |m_t| <= (1 - b1)
    sqrt(sum_k (b1^2/b2)^k) sqrt(v_t / (1 - b2)), then the bias
    corrections. With b1^2 <= b2 it is about 1 (1 exactly at t = 1)."""
    r = cfg.b1 ** 2 / cfg.b2
    return ((1 - cfg.b1) * math.sqrt(1 - cfg.b2 ** t)
            / ((1 - cfg.b1 ** t) * math.sqrt(1 - cfg.b2))
            * math.sqrt((1 - r ** t) / (1 - r)))


def params_within(a, b, bound: float, dev) -> tuple:
    """(max |a - b|, share of elements beyond one float32 rounding of
    the update, whether every element is within ``bound`` plus one
    rounding of |b|) over two parameter trees, compared on ``dev``."""
    from repro_torch.dist.lcmp_collectives import tree_flatten
    worst, far, total, ok = 0.0, 0, 0, True
    for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]):
        x, y = x.detach().to(dev), y.detach().to(dev)
        d = (x - y).abs()
        ulp = 2.4e-7 * (y.abs() + bound)    # float32 rounding of p and of the update
        worst = max(worst, float(d.max()))
        ok &= bool((d <= bound + ulp).all())
        far += int((d > 2e-7 + ulp).sum())
        total += d.numel()
    return worst, far / total, ok


def int8_block_errors(reduced, grads, chunk: int = 1 << 24) -> tuple:
    """Per 1024-element scale block of the int8-reduced gradient
    ``reduced`` (M,) against the exact pod mean of ``grads`` (n, M):
    (the largest error over the block's own scale, where that scale is
    nonzero; whether every block is within 2.1 of its scale). The scale
    is the largest |g| of the block over the pods / 127. Each wire leg
    errs by under one step of its own block (leg 1's partial mean by the
    mean of the pods' steps, leg 2 by the mean's step, whose amax is at
    most the pods'), so the error is under 2 scales. Chunks of
    ``chunk`` elements keep the temporaries small at the train size."""
    worst, ok, M = 0.0, True, reduced.numel()
    for o in range(0, M, chunk):
        g, r = grads[:, o:o + chunk], reduced[o:o + chunk]
        err = (r - g.mean(0)).abs()
        amax = g.abs().amax(0)
        pad = -err.numel() % 1024
        err = torch.nn.functional.pad(err, (0, pad)).view(-1, 1024).amax(1)
        scale = torch.nn.functional.pad(amax, (0, pad)).view(-1, 1024).amax(1) / 127
        ok &= bool((err <= 2.1 * scale).all())
        nz = scale > 0
        if nz.any():
            worst = max(worst, float((err[nz] / scale[nz]).max()))
    return worst, ok


def qsr_device_ms(prof) -> dict:
    """Device ms of each qsr kernel, and the top device kernels, in a
    profiled step."""
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    own = {k: sum(v for n, v in by_name.items() if f"{k}_kernel" in n)
           for k in ("qsr_int8", "qsr_dequant")}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"qsr_device_ms": own, "device_busy_ms": sum(by_name.values()),
            "kernels": len(kern), "top_device_ms": {n[:90]: v for n, v in top}}


def phase_train(dev) -> dict:
    """The multi-pod LCMP train step at qwen3-4b's full width on the card:
    2 pods, 3 steps over the int8 wire, then one f32-wire step from the
    state after step 2, compared with int8 step 3."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.synth import batch_at
    from repro_torch.dist import compress
    from repro_torch.dist import lcmp_collectives as lc
    from repro_torch.dist.lcmp_collectives import PodAxis, tree_flatten
    from repro_torch.kernels import ops
    from repro_torch.train import optim
    from repro_torch.train.step import (TrainConfig, init_train_state,
                                        make_train_step)
    cfg = train_config()
    M = cfg.param_count()
    axis = PodAxis("pod", TRAIN_PODS)
    steps = {mode: make_train_step(cfg, TrainConfig(pod_reduce=mode,
                                                    pod_axis=axis))
             for mode in ("lcmp_int8", "lcmp")}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, opt = init_train_state(cfg, 0, device=dev)
    lc._TELEMETRY.reset()
    ids, routes = reference_buckets(M)
    want_bytes = reference_route_bytes(M)

    def run(mode: str, k: int, prof=None) -> dict:
        nonlocal params, opt
        batch = batch_at(cfg, k, batch=TRAIN_PODS, seq=TRAIN_SEQ, device=dev)
        step = steps[mode]
        torch.cuda.synchronize()
        before, rb = ops.counts(), lc._TELEMETRY.route_bytes.copy()
        t0 = time.perf_counter()
        if prof is None:
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
        else:
            with prof:
                params, opt, m = step(params, opt, batch)
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = ops.counts()
        rec = {"mode": mode, "step": k + 1, "wall_s": wall,
               "tokens_per_s": TRAIN_PODS * TRAIN_SEQ / wall,
               "loss": m["loss"].tolist(), "grad_norm": float(m["grad_norm"]),
               "split_ms": step.split_ms(), "profiled": prof is not None,
               "launches": {n: after[n] - before[n]
                            for n in ("qsr_int8", "qsr_dequant")},
               "route_bytes": (lc._TELEMETRY.route_bytes - rb).tolist()}
        require(all(math.isfinite(v) for v in rec["loss"])
                and math.isfinite(rec["grad_norm"]),
                f"train step {k + 1} ({mode}): finite loss and grad_norm")
        require(rec["route_bytes"] == want_bytes[mode].tolist(),
                f"train step {k + 1} ({mode}): route_bytes as the reference's loop")
        require(np.array_equal(lc._TELEMETRY.bucket_routes, routes),
                f"train step {k + 1} ({mode}): buckets bound as schedule_buckets")
        if mode == "lcmp_int8":
            worst, ok = int8_block_errors(step.reduced, step.grads)
            rec["int8_err_over_block_scale"] = worst
            require(ok, f"train step {k + 1}: int8 gradient within 2.1 of "
                    "each block's own scale of the exact pod mean")
        return rec

    ops.reset_counts()                      # the main path: 3 int8 steps
    records = [run("lcmp_int8", 0), run("lcmp_int8", 1)]
    saved = [[x.detach().to("cpu", copy=True) for x in tree_flatten(t)[0]]
             for t in (params, opt.mu, opt.nu)]
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    records.append(run("lcmp_int8", 2, prof))
    launches = ops.counts()
    peak = torch.cuda.max_memory_allocated()
    profiled = qsr_device_ms(prof)
    del prof
    int8_step = steps["lcmp_int8"]
    wire = compress.encode(int8_step.grads[0], seed=int(ids[0]))
    wire_ratio = compress.wire_bytes(wire) / (4 * M)
    del wire
    p_int8 = [x.detach().to("cpu", copy=True) for x in tree_flatten(params)[0]]
    int8_step.grads = int8_step.reduced = None
    torch.cuda.empty_cache()

    with torch.no_grad():                   # back to the state after step 2
        for tree, host in zip((params, opt.mu, opt.nu), saved):
            for x, h in zip(tree_flatten(tree)[0], host):
                x.copy_(h)
    opt = optim.AdamWState(count=torch.tensor(2, dtype=torch.int32, device=dev),
                           mu=opt.mu, nu=opt.nu)
    del saved
    records.append(run("lcmp", 2))
    ocfg = optim.AdamWConfig()
    lr3 = float(optim._schedule(ocfg, torch.tensor(3.0)))
    limit = 2 * lr3 * adam_bound(ocfg, 3)
    worst, far, ok = params_within(p_int8, tree_flatten(params)[0], limit, dev)
    timed = records[1]                      # int8, after a warm-up step
    out = {"phase": "train", "config": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab, "params": M,
           "pods": TRAIN_PODS, "seq_per_pod": TRAIN_SEQ,
           "act_dtype": cfg.act_dtype, "records": records,
           "launches": {n: launches[n] for n in ("qsr_int8", "qsr_dequant")},
           "launches_per_int8_step": {n: launches[n] / 3
                                      for n in ("qsr_int8", "qsr_dequant")},
           "int8_step_wall_s": timed["wall_s"],
           "int8_step_split_ms": timed["split_ms"],
           "tokens_per_s": timed["tokens_per_s"],
           "f32_step_wall_s": records[3]["wall_s"],
           "f32_step_split_ms": records[3]["split_ms"],
           "profiled_int8_step": profiled,
           "wire_bytes_over_f32": wire_ratio,
           "int8_vs_f32_params_max_diff": worst,
           "int8_vs_f32_params_limit": limit,
           "int8_vs_f32_share_beyond_rounding": far,
           "max_memory_allocated": peak}
    emit(out)
    require(launches["qsr_int8"] == 3 * 2 * TRAIN_PODS
            and launches["qsr_dequant"] == 3 * (TRAIN_PODS + 1),
            "train: the int8 steps launched both qsr kernels, 2n and n+1 a step")
    require(all(v == 0 for v in records[3]["launches"].values()),
            "train: the f32-wire step launched no qsr kernel")
    require(all(v > 0 for v in profiled["qsr_device_ms"].values()),
            "train: the profiler saw both qsr kernels run")
    require(wire_ratio <= 0.26, "train: int8 wire at most 0.26 of f32 bytes")
    require(ok and far < FAR_SHARE, f"train: int8 and f32 paths' parameters "
            f"within {limit:.3g} after one step from the same state, beyond "
            f"float32 rounding on under {FAR_SHARE:.0%}")
    return out


def phase_train_device_vs_cpu(dev) -> dict:
    """One smoke-size 2-pod int8 step (bf16 activations) on the card and
    on the CPU from the same weights and batch. bf16 matmuls round at
    other places on the two, so: losses within rtol 2e-2; the pods' flat
    gradients within 5e-2 relative L2 (measured 1.1e-2 between bf16 and
    f32 activations on the CPU); parameters within AdamW's first-step
    bound 2 lr_1 (the normalized update flips only where |g| is tiny) on
    every element, and beyond float32 rounding on under 5% of them. The
    reduce itself is exact arithmetic around bit-exact kernels, so the
    card's reduce of its pods' gradients must equal the CPU's plain
    reduce of the same gradients bit for bit."""
    from repro_torch import configs
    from repro_torch.data.synth import batch_at
    from repro_torch.dist import lcmp_collectives as lc
    from repro_torch.dist.lcmp_collectives import PodAxis, tree_flatten
    from repro_torch.kernels import ops
    from repro_torch.models import carry
    from repro_torch.train import optim
    from repro_torch.train.step import (TrainConfig, init_train_state,
                                        make_train_step)
    cfg = configs.get("qwen3_4b", smoke=True)
    tcfg = TrainConfig(pod_reduce="lcmp_int8", pod_axis=PodAxis("pod", 2))
    params_c, opt_c = init_train_state(cfg, 0, device="cpu")
    params_g = carry.params_from_reference(carry.to_numpy(params_c), device=dev)
    opt_g = optim.adamw_init(params_g)
    batch_c = batch_at(cfg, 0, batch=4, seq=64, device="cpu")
    batch_g = {k: v.to(dev) for k, v in batch_c.items()}
    step_g, step_c = make_train_step(cfg, tcfg), make_train_step(cfg, tcfg)
    ops.reset_counts()
    params_g, _, mg = step_g(params_g, opt_g, batch_g)
    torch.cuda.synchronize()
    launches = ops.counts()
    params_c, _, mc = step_c(params_c, opt_c, batch_c)
    ocfg = optim.AdamWConfig()
    limit = 2 * float(optim._schedule(ocfg, torch.tensor(1.0))) * adam_bound(ocfg, 1)
    worst, far, ok = params_within(tree_flatten(params_g)[0],
                                   tree_flatten(params_c)[0], limit,
                                   torch.device("cpu"))
    reduced_exact = torch.equal(step_g.reduced.cpu(), lc.pod_reduce_flat(
        step_g.grads.cpu(), tcfg.pod_axis, compress=True))
    gc = step_c.grads
    grad_rel = float((step_g.grads.cpu() - gc).norm() / gc.norm())
    lc._TELEMETRY.reset()
    out = {"phase": "train_device_vs_cpu", "config": cfg.name,
           "act_dtype": cfg.act_dtype, "loss_gpu": mg["loss"].tolist(),
           "loss_cpu": mc["loss"].tolist(), "grad_norm_gpu": float(mg["grad_norm"]),
           "grad_norm_cpu": float(mc["grad_norm"]), "grad_rel_l2": grad_rel,
           "reduced_equals_cpu_reduce": reduced_exact,
           "params_max_diff": worst, "params_limit": limit,
           "params_share_beyond_rounding": far,
           "launches": {n: launches[n] for n in ("qsr_int8", "qsr_dequant")}}
    emit(out)
    require(np.allclose(out["loss_gpu"], out["loss_cpu"], rtol=2e-2, atol=0),
            "train device vs cpu: losses within rtol 2e-2")
    require(grad_rel <= 5e-2, "train device vs cpu: gradients within 5e-2")
    require(reduced_exact, "train device vs cpu: the card's int8 reduce of its "
            "pods' gradients equals the CPU's plain reduce of them, bit for bit")
    require(ok and far < 0.05, "train device vs cpu: parameters within "
            "AdamW's bound, beyond rounding on under 5%")
    require(launches["qsr_int8"] == 4 and launches["qsr_dequant"] == 3,
            "train device vs cpu: the card step ran the qsr kernels")
    return out


# ------------------------------------------------ the dist layer, 2 ranks
def digest(t: torch.Tensor, chunk: int = 1 << 26) -> list:
    """An exact digest of a float32 tensor's bits: its length, the sum
    of its bit patterns and their sum weighted by (index mod 65521) + 1,
    in int64 on its device."""
    v = t.detach().reshape(-1).view(torch.int32)
    s0 = s1 = 0
    for o in range(0, v.numel(), chunk):
        x = v[o:o + chunk].to(torch.int64)
        wt = torch.arange(o, o + x.numel(), device=x.device) % 65521 + 1
        s0 += int(x.sum())
        s1 += int((x * wt).sum())
    return [v.numel(), s0, s1]


def pod_vector(dev, m: int, pod: int) -> torch.Tensor:
    """Pod ``pod``'s gradient for phase dist's reduce: normal values,
    each 1024-element block scaled by 1e-3, 1 or 100, from its seed."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(DIST_SEED + pod)
    x = torch.randn(-(-m // 1024) * 1024, generator=gen, device=dev)
    pick = torch.randint(0, 3, (x.numel() // 1024,), generator=gen, device=dev)
    mag = torch.tensor([1e-3, 1.0, 100.0], device=dev)[pick]
    x.view(-1, 1024).mul_(mag[:, None])
    return x[:m]


def reference_buckets(m: int) -> tuple:
    """The reference's bucket ids of a flat vector of ``m`` elements, and
    the routes ``schedule_buckets`` binds them to."""
    from repro_torch.dist import lcmp_collectives as lc
    nb = -(-m // lc.BUCKET_ELEMS)
    ids = lc._fmix32_host(np.arange(nb, dtype=np.uint32) + np.uint32(1))
    return ids, lc.schedule_buckets(ids)


def reference_route_bytes(m: int) -> dict:
    """The bytes one pod's reduce of ``m`` elements puts on each route,
    by the reference's accounting loop, for the int8 (``lcmp_int8``) and
    f32 (``lcmp``) wires."""
    from repro_torch.dist import lcmp_collectives as lc
    routes = reference_buckets(m)[1]
    out = {mode: np.zeros(lc.NUM_ROUTES, np.int64)
           for mode in ("lcmp_int8", "lcmp")}
    for b in range(len(routes)):
        blen = min((b + 1) * lc.BUCKET_ELEMS, m) - b * lc.BUCKET_ELEMS
        out["lcmp_int8"][routes[b]] += blen + 4 * (-(-blen // 1024))
        out["lcmp"][routes[b]] += 4 * blen
    return out


def dist_rank(rank: int, port: int, q) -> None:
    """One rank of phase dist: one pod on ``cuda:0`` in a Gloo group of
    ``DIST_RANKS``. Reduces its own pod vector over the group in both
    wire modes, then runs one ``lcmp_int8`` train step of phase train's
    cell as its pod; puts what it saw on ``q``."""
    import datetime
    import traceback
    try:
        import torch.distributed as dist
        sys.path.insert(0, os.path.join(HERE, "src"))
        from repro_torch.data.synth import batch_at
        from repro_torch.dist import lcmp_collectives as lc
        from repro_torch.dist.lcmp_collectives import tree_flatten
        from repro_torch.kernels import ops
        from repro_torch.train.step import (TrainConfig, init_train_state,
                                            make_train_step)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=DIST_RANKS, rank=rank,
                                timeout=datetime.timedelta(seconds=300))
        group = lc.PodGroup()
        cfg = train_config()
        m = cfg.param_count()
        out = {"rank": rank, "reduce": {}}
        ops.reset_counts()                  # the main path: reduces, step
        for mode in ("lcmp_int8", "lcmp"):
            x = pod_vector(dev, m, rank)
            lc._TELEMETRY.reset()
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = lc.pod_reduce_flat(x, group, compress=mode == "lcmp_int8")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            out["reduce"][mode] = {
                "wall_s": wall, "leg_s": dict(lc._TELEMETRY.leg_s),
                "route_bytes": lc._TELEMETRY.route_bytes.tolist(),
                "digest": digest(got)}
            del x, got
        out["reduce_launches"] = {n: ops.counts()[n]
                                  for n in ("qsr_int8", "qsr_dequant")}
        out["reduce_peak_bytes"] = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        lc._TELEMETRY.reset()
        params, opt = init_train_state(cfg, 0, device=dev)
        step = make_train_step(cfg, TrainConfig(pod_reduce="lcmp_int8",
                                                pod_axis=group))
        batch = batch_at(cfg, 0, batch=TRAIN_PODS, seq=TRAIN_SEQ, device=dev)
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batch)
        torch.cuda.synchronize()
        out["step"] = {
            "wall_s": time.perf_counter() - t0, "split_ms": step.split_ms(),
            "leg_s": dict(lc._TELEMETRY.leg_s),
            "loss": met["loss"].tolist(), "grad_norm": float(met["grad_norm"]),
            "route_bytes": lc._TELEMETRY.route_bytes.tolist(),
            "params_digest": [digest(p) for p in tree_flatten(params)[0]],
            "peak_bytes": torch.cuda.max_memory_allocated()}
        counts = ops.counts()
        out["launches"] = {n: counts[n] for n in ("qsr_int8", "qsr_dequant")}
        dist.barrier()
        dist.destroy_process_group()
        q.put(out)
    except BaseException:
        q.put({"rank": rank, "error": traceback.format_exc()})
        raise


def phase_dist(dev, train: dict) -> dict:
    """The dist layer across processes on the card: ``DIST_RANKS`` ranks,
    each one pod on ``cuda:0`` in a Gloo group (NCCL refuses two ranks on
    one device). (a) Each rank reduces its own pod vector of phase
    train's gradient size over the group (``PodGroup``), int8 and f32
    wires: every rank's result equals the one-process ``PodAxis`` reduce
    of the same vectors on the card bit for bit (exact digests), and its
    route bytes the reference's accounting loop. (b) Each rank runs one
    ``lcmp_int8`` step of phase train's cell as its pod, from seed 0 on
    phase train's first batch: the ranks' parameters are equal bit for
    bit, and their losses and norm within rtol 1e-3 of phase train's
    first step (CUDA's backward kernels need not repeat bits across
    processes). Each rank's qsr launches join the kernels line."""
    import socket

    import torch.multiprocessing as tmp

    from repro_torch.dist import lcmp_collectives as lc
    from repro_torch.dist.lcmp_collectives import PodAxis
    cfg = train_config()
    m = cfg.param_count()
    want_bytes = reference_route_bytes(m)
    oracle = {}
    torch.cuda.empty_cache()
    for mode in ("lcmp_int8", "lcmp"):      # the one-process reduce
        flat = torch.stack([pod_vector(dev, m, p) for p in range(DIST_RANKS)])
        got = lc.pod_reduce_flat(flat, PodAxis("pod", DIST_RANKS),
                                 compress=mode == "lcmp_int8")
        oracle[mode] = digest(got)
        del flat, got
    lc._TELEMETRY.reset()
    torch.cuda.empty_cache()
    parent_bytes = torch.cuda.memory_allocated()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = tmp.get_context("spawn")
    q = ctx.Queue()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=dist_rank, args=(r, port, q))
             for r in range(DIST_RANKS)]
    for p in procs:
        p.start()
    try:
        ranks = sorted((q.get(timeout=600) for _ in procs),
                       key=lambda r: r["rank"])
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    wall = time.perf_counter() - t0
    for r in ranks:
        require("error" not in r, f"dist: rank {r['rank']} failed:\n"
                f"{r.get('error')}")
    first = train["records"][0]             # phase train's first int8 step
    out = {"phase": "dist", "ranks": DIST_RANKS, "backend": "gloo",
           "config": cfg.name, "layers": cfg.n_layers, "params": m,
           "wall_s": wall, "parent_allocated_bytes": parent_bytes,
           "per_rank": ranks,
           "train_step1_loss": first["loss"],
           "train_step1_grad_norm": first["grad_norm"],
           "launches": {n: sum(r["launches"][n] for r in ranks)
                        for n in ("qsr_int8", "qsr_dequant")}}
    emit(out)
    for r in ranks:
        for mode in ("lcmp_int8", "lcmp"):
            red = r["reduce"][mode]
            require(red["digest"] == oracle[mode], f"dist: rank {r['rank']}'s "
                    f"{mode} reduce equals the one-process PodAxis reduce bit "
                    "for bit")
            require(red["route_bytes"] == want_bytes[mode].tolist(),
                    f"dist: rank {r['rank']}'s {mode} route_bytes as the "
                    "reference's loop")
        st = r["step"]
        require(st["params_digest"] == ranks[0]["step"]["params_digest"],
                f"dist: rank {r['rank']}'s parameters equal rank 0's bit for bit")
        require(st["route_bytes"] == want_bytes["lcmp_int8"].tolist(),
                f"dist: rank {r['rank']}'s step route_bytes")
        require(np.allclose(st["loss"], first["loss"], rtol=1e-3, atol=0)
                and np.isclose(st["grad_norm"], first["grad_norm"], rtol=1e-3,
                               atol=0),
                f"dist: rank {r['rank']}'s losses and norm within rtol 1e-3 of "
                "phase train's first step")
        require(r["reduce_launches"] == {"qsr_int8": 2, "qsr_dequant": 2}
                and r["launches"] == {"qsr_int8": 4, "qsr_dequant": 4},
                f"dist: rank {r['rank']} launched both qsr kernels, 2 and 2 "
                "an int8 reduce")
    return out


# ------------------------------------------------- the attention decoders
def cut_config(arch: str, layers: int):
    from repro_torch import configs
    return dataclasses.replace(configs.get(arch), n_layers=layers)


def seeded_tokens(dev, vocab: int, shape, seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, shape, generator=gen).to(dev)


def one_token_groups():
    """``layers.moe_block`` with each token in a dispatch group of its
    own, as a decode step dispatches it (with larger groups the
    reference's per-rank slot count sums tokens: ROADMAP.md queue C)."""
    from unittest import mock

    from repro_torch.models import layers
    grouped = layers.moe_block
    return mock.patch.object(layers, "moe_block", lambda *a, **k: grouped(
        *a, **{**k, "group_size": 1}))


def decode_all(params, cfg, tokens: torch.Tensor, cache=None) -> tuple:
    """Teacher-forced decode of every position (from ``cache``, default a
    fresh one) -> (logits (B,S,V), device ms per step from CUDA events)."""
    from repro_torch.serve.decode import decode_step, init_cache
    B, S = tokens.shape
    if cache is None:
        cache = init_cache(cfg, B, S, device=tokens.device)
    positions = torch.arange(S, device=tokens.device)
    outs = []
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(S):
        lg, cache = decode_step(params, cfg, cache, tokens[:, i:i + 1],
                                positions[i])
        outs.append(lg[:, 0])
    b.record()
    torch.cuda.synchronize()
    return torch.stack(outs, 1), a.elapsed_time(b) / S


def decode_agreement(dec: torch.Tensor, fwd: torch.Tensor) -> dict:
    diff = (dec - fwd).abs()
    return {"max_abs_err": float(diff.max()),
            "within": bool((diff <= DECODE_TOL + DECODE_TOL * fwd.abs()).all())}


def seeded_extra(dev, cfg, batch: int, seed: int):
    """A vlm's patch embeddings or an encdec's frame embeddings, normal x
    0.02 as ``data.synth.batch_at`` draws them; None for the others."""
    n = {"vlm": cfg.n_patches, "encdec": cfg.enc_seq}.get(cfg.family)
    if n is None:
        return None
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((batch, n, cfg.d_model), generator=gen) * 0.02).to(dev)


def check_family(dev, arch: str) -> dict:
    """One configuration at full width: teacher-forced decode of 64
    tokens against ``forward`` (a moe forward with one-token dispatch
    groups, the grouped forward's distance recorded beside it; whisper's
    forward on its frames, its decode from the cross cache
    ``prefill_cross_cache`` makes of the encoder's output; internvl2's
    decode, which has no patch prefix in either package, against the
    dense-family forward of the same parameters, and its vlm forward on
    patches finite and of the tokens' shape), with the moe drops of both
    passes. A configuration of ``ORACLE_F32`` also runs its forward and
    decode in float32 on the same weights: that oracle is held, the bf16
    distances recorded beside the bf16 forward's own from float32."""
    from repro_torch.models import arch as A
    from repro_torch.models import layers
    from repro_torch.serve.decode import init_cache, prefill_cross_cache
    cfg = cut_config(arch, FAMILY_LAYERS[arch])
    torch.cuda.reset_peak_memory_stats()
    params = A.init_params(cfg, 0, device=dev)
    tokens = seeded_tokens(dev, cfg.vocab, (1, FAMILY_SEQ), 19)
    extra = seeded_extra(dev, cfg, 1, 23)
    out = {"config": cfg.name, "family": cfg.family, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "params": cfg.param_count(),
           "active_params": cfg.active_param_count(),
           "act_dtype": cfg.act_dtype, "seq": FAMILY_SEQ}
    moe = cfg.family == "moe"
    with torch.no_grad(), layers.record_drops() as drops:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if moe:
            with one_token_groups():
                fwd = A.forward(params, cfg, tokens)
        elif cfg.family == "vlm":
            fwd = A.forward(params, dataclasses.replace(cfg, family="dense"),
                            tokens)
        else:
            fwd = A.forward(params, cfg, tokens, extra=extra)
        torch.cuda.synchronize()
        out["forward_s"] = time.perf_counter() - t0
        cache = None
        if cfg.family == "encdec":
            cache = init_cache(cfg, 1, FAMILY_SEQ, device=dev)
            cache["cross"] = prefill_cross_cache(params, cfg,
                                                 A.encode(params, cfg, extra))
        dec, out["decode_ms_per_step"] = decode_all(params, cfg, tokens, cache)
        del cache
        out["drops"] = sum(int(d) for d in drops)
        out["moe_calls"] = len(drops)
        if moe:
            with layers.record_drops() as gdrops:
                grouped = A.forward(params, cfg, tokens)
            out["grouped_forward_vs_decode_max_abs"] = float(
                (dec - grouped).abs().max())
            out["grouped_forward_drops"] = sum(int(d) for d in gdrops)
            del grouped
        if arch in ORACLE_F32:
            c32 = dataclasses.replace(cfg, act_dtype="float32")
            f32 = A.forward(params, c32, tokens)
            d32, ms32 = decode_all(params, c32, tokens)
            out["float32"] = {**decode_agreement(d32, f32),
                              "decode_ms_per_step": ms32,
                              "finite": bool(torch.isfinite(d32).all())}
            out["bf16_forward_vs_f32_forward"] = float((fwd - f32).abs().max())
            out["bf16_decode_vs_f32_forward"] = float((dec - f32).abs().max())
            del f32, d32
        if cfg.family == "vlm":
            vlm = A.forward(params, cfg, tokens, extra=extra)
            out["vlm_forward_ok"] = bool(torch.isfinite(vlm).all()) and \
                tuple(vlm.shape) == tuple(fwd.shape)
            out["vlm_forward_vs_dense_max_abs"] = float((vlm - fwd).abs().max())
            del vlm
    out.update(decode_agreement(dec, fwd))
    out["finite"] = bool(torch.isfinite(fwd).all() and torch.isfinite(dec).all())
    out["shape_ok"] = tuple(dec.shape) == tuple(fwd.shape) == (1, FAMILY_SEQ, cfg.vocab)
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del params, fwd, dec
    torch.cuda.empty_cache()
    return out


def leaf_paths(tree: dict, pre: str = "") -> list:
    """``a/b/c`` names of a nested dict's leaves, in flatten order."""
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out += leaf_paths(tree[k], pre + k + "/")
        else:
            out.append(pre + k)
    return out


def check_hybrid_gradient(dev) -> dict:
    """One zamba2-1.2b train step at full width, depth cut to 1 layer, at
    ``LAUNCH_SEQ``: the loss finite, and the gradient leaves that are
    non-finite before clipping exactly ``HYBRID_NONFINITE``, the
    reference's set. ``mamba2_ssd`` forms ``where(causal, exp(seg), 0)``:
    above the diagonal of a 128-token chunk ``exp`` overflows, the
    forward discards it and the backward makes 0 * inf = NaN. The port
    reproduces the reference here and does not repair it; clipping by
    the global norm then makes every parameter NaN."""
    from repro_torch.data.synth import batch_at
    from repro_torch.dist.lcmp_collectives import tree_flatten
    from repro_torch.train.step import init_train_state, make_train_step
    cfg = cut_config("zamba2_1p2b", 1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, opt = init_train_state(cfg, 0, device=dev)
    names = leaf_paths(params)
    sizes = [p.numel() for p in tree_flatten(params)[0]]
    step = make_train_step(cfg)
    batch = batch_at(cfg, 0, batch=1, seq=LAUNCH_SEQ, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    bad, o = [], 0
    for name, k in zip(names, sizes):
        if not bool(torch.isfinite(step.grads[0, o:o + k]).all()):
            bad.append(name)
        o += k
    out = {"config": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": cfg.param_count(), "seq": LAUNCH_SEQ,
           "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "nonfinite_grad_leaves": bad, "expected": sorted(HYBRID_NONFINITE),
           "leaves": len(names),
           "nonfinite_params_after_step": sum(
               not bool(torch.isfinite(p).all())
               for p in tree_flatten(params)[0]),
           "step_s": step_s,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "note": "reproduces the reference's mamba2_ssd exp(seg) overflow "
                   "(ROADMAP.md queue C); not repaired"}
    del params, opt, step, batch
    torch.cuda.empty_cache()
    return out


def bf16_matrices(tree: dict) -> dict:
    """Every leaf of two or more dimensions as a bf16 copy (norm scales
    stay f32, as ``rms_norm`` reads them)."""
    return {k: bf16_matrices(v) if isinstance(v, dict)
            else v.detach().to(torch.bfloat16) if v.dim() >= 2 else v.detach()
            for k, v in tree.items()}


def check_gemma_long(dev) -> dict:
    """gemma2-9b on a prompt of its window + 64 tokens: the last 64
    decode positions mask the keys beyond the 4096-token window on the
    local layers and still match ``forward``."""
    from repro_torch.models import arch as A
    cfg = cut_config("gemma2_9b", GEMMA_LONG_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    # the matrices held in bf16: the very values each use's cast makes, so
    # forward and decode compute what they compute on the f32 weights,
    # without casting 2.6 B weights again at each of the 4160 steps
    params = bf16_matrices(A.init_params(cfg, 0, device=dev))
    tokens = seeded_tokens(dev, cfg.vocab, (1, GEMMA_LONG), 20)
    with torch.no_grad():
        fwd = A.forward(params, cfg, tokens)[:, -64:]
        t0 = time.perf_counter()
        dec, ms = decode_all(params, cfg, tokens)
        wall = time.perf_counter() - t0
        dec = dec[:, -64:]
    out = {"config": cfg.name, "layers": cfg.n_layers, "seq": GEMMA_LONG,
           "window": cfg.window, "compared_positions": 64,
           "decode_ms_per_step": ms, "decode_wall_s": wall,
           **decode_agreement(dec, fwd),
           "finite": bool(torch.isfinite(dec).all()),
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    del params, fwd, dec
    torch.cuda.empty_cache()
    return out


def check_local_block(dev) -> dict:
    """``local_block_attention`` against windowed ``gqa_attention`` on the
    same random bf16 q/k/v at gemma2's shapes (S = 3 windows)."""
    from repro_torch.models import layers
    lb = LOCAL_BLOCK
    gen = torch.Generator(device=dev).manual_seed(21)
    q, k, v = (torch.randn((1, lb["S"], h, lb["hd"]), generator=gen,
                           device=dev).to(torch.bfloat16)
               for h in (lb["Hq"], lb["Hkv"], lb["Hkv"]))
    with torch.no_grad():
        blocks = cuda_ms(lambda: layers.local_block_attention(
            q, k, v, window=lb["window"], softcap=lb["softcap"]), 2)
        got = layers.local_block_attention(q, k, v, window=lb["window"],
                                           softcap=lb["softcap"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        want = layers.gqa_attention(q, k, v, window=lb["window"],
                                    softcap=lb["softcap"])
        torch.cuda.synchronize()
        full_peak = torch.cuda.max_memory_allocated()
        err = float((got.float() - want.float()).abs().max())
        full = cuda_ms(lambda: layers.gqa_attention(
            q, k, v, window=lb["window"], softcap=lb["softcap"]), 2)
    del q, k, v, got, want
    torch.cuda.empty_cache()
    return {**lb, "max_abs_err": err, "local_block_ms": blocks,
            "windowed_full_ms": full, "windowed_full_peak_bytes": full_peak}


def phase_families(dev) -> dict:
    """Phase families (see the module docstring)."""
    from repro_torch.kernels import ops
    ops.reset_counts()
    local = check_local_block(dev)
    rows = [check_family(dev, arch) for arch in FAMILY_LAYERS]
    long = check_gemma_long(dev)
    hybrid = check_hybrid_gradient(dev)
    out = {"phase": "families", "tolerance": DECODE_TOL, "local_block": local,
           "configs": rows, "gemma_long": long, "hybrid_gradient": hybrid,
           "launches": ops.counts()}
    emit(out)
    require(local["max_abs_err"] <= 2e-2, "families: local_block_attention "
            "within 2e-2 of windowed gqa_attention at gemma2's shapes")
    for r in rows:
        what = f"families {r['config']}"
        require(r["finite"] and r["shape_ok"], f"{what}: finite logits of "
                "the expected shape")
        require(r["drops"] == 0, f"{what}: no token dropped by the forward "
                "or the decode")
        held = r.get("float32", r)
        require(held["finite"] and held["within"], f"{what}: teacher-forced "
                f"decode within {DECODE_TOL} of forward (max "
                f"{held['max_abs_err']:.4g}{' in float32' if held is not r else ''})")
        if r["family"] == "vlm":
            require(r["vlm_forward_ok"], f"{what}: the forward with patches "
                    "is finite and of the tokens' shape")
    require(long["finite"] and long["within"], "families gemma2 long: the "
            "last 64 decode positions past the window match forward")
    require(math.isfinite(hybrid["loss"]) and
            hybrid["nonfinite_grad_leaves"] == hybrid["expected"],
            "families hybrid gradient: finite loss, and the non-finite "
            "gradient leaves before clipping are the reference's "
            f"{hybrid['expected']} (got {hybrid['nonfinite_grad_leaves']}); "
            "the port reproduces the reference's mamba2_ssd overflow")
    require(not any(out["launches"].values()), "families: no kernel of ours "
            "on the model path")
    return out


def phase_serve(dev) -> dict:
    """Phase serve: ``launch.serve.prefill_then_decode`` at the reference
    launcher's defaults for each configuration of ``SERVE_LAYERS`` (the
    vlm without patches, as the reference's launcher runs it)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import prefill_then_decode
    from repro_torch.models.arch import init_params
    B, P, G = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    rows = []
    ops.reset_counts()
    for arch, layers in SERVE_LAYERS.items():
        cfg = cut_config(arch, layers)
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, 0, device=dev)
        prompt = seeded_tokens(dev, cfg.vocab, (B, P), 22)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = prefill_then_decode(cfg, params, prompt, G)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rows.append({"config": cfg.name, "layers": layers, "batch": B,
                     "prompt": P, "gen": G, "wall_s": wall,
                     "tokens_per_s": B * (P + G) / wall,
                     "generated_tokens_per_s": B * G / wall,
                     "ms_per_decode_step": 1e3 * wall / (P + G),
                     "max_memory_allocated": torch.cuda.max_memory_allocated(),
                     "shape": list(toks.shape),
                     "in_vocab": bool(((toks >= 0) & (toks < cfg.vocab)).all()),
                     "first_tokens": toks[0, :8].tolist()})
        del params, toks
        torch.cuda.empty_cache()
    out = {"phase": "serve", "configs": rows, "launches": ops.counts()}
    emit(out)
    for r in rows:
        require(r["shape"] == [B, G] and r["in_vocab"],
                f"serve {r['config']}: (batch, gen) tokens inside the vocab")
    require(not any(out["launches"].values()), "serve: no kernel of ours "
            "on the model path")
    return out


def launch_quiet(fn, *a, **kw):
    """Run a launcher call with its printed lines captured -> (result or
    the SystemExit, the printed text)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            res = fn(*a, **kw)
        except SystemExit as e:
            res = e
    return res, buf.getvalue()


def checkpoint_mechanics(dev, arch: str) -> dict:
    """The launcher's checkpoints at ``arch``'s smoke size on the card: 4
    steps saving every 2; a 2-step run resumed to 4 (restored state equal
    to the saved one bit for bit, the optimizer count 4, step 3's loss
    the uninterrupted run's within rtol 1e-3); a SIGTERM inside step 3
    leaves its emergency checkpoint."""
    import tempfile
    from unittest import mock

    from repro_torch import configs
    from repro_torch.dist.lcmp_collectives import tree_flatten
    from repro_torch.launch import train as launcher
    from repro_torch.train import checkpoint as ckpt
    cfg = configs.get(arch, smoke=True)
    kw = dict(steps=4, batch=2, seq=64, ckpt_every=2, log_every=1, device=dev)

    def same(a, b) -> bool:
        return all(torch.equal(x.detach(), y.detach()) for x, y in
                   zip(tree_flatten(a)[0], tree_flatten(b)[0]))

    def like() -> dict:
        params, opt = launcher.init_train_state(cfg, 1, device=dev)
        return {"params": params, "opt": opt}

    with tempfile.TemporaryDirectory() as tmp:
        whole, _ = launch_quiet(launcher.train, cfg, ckpt_dir=f"{tmp}/whole", **kw)
        saved4 = ckpt.restore(ckpt.latest(f"{tmp}/whole")[1], like())
        half, _ = launch_quiet(launcher.train, cfg, ckpt_dir=f"{tmp}/half",
                               **{**kw, "steps": 2})
        saved2 = ckpt.restore(ckpt.latest(f"{tmp}/half")[1], like())
        resumed, text = launch_quiet(launcher.train, cfg, ckpt_dir=f"{tmp}/half",
                                     resume=True, **kw)
        make = launcher.make_train_step

        def make_step(c, t):
            step = make(c, t)

            def run(params, opt, batch):
                if int(opt.count) == 2:
                    os.kill(os.getpid(), signal.SIGTERM)
                return step(params, opt, batch)
            return run
        with mock.patch.object(launcher, "make_train_step", make_step):
            term, term_text = launch_quiet(launcher.train, cfg,
                                           ckpt_dir=f"{tmp}/term",
                                           **{**kw, "steps": 6, "ckpt_every": 10})
        found = ckpt.latest(f"{tmp}/term")
        saved_t = ckpt.restore(found[1], like()) if found else None
    loss3 = {"whole": whole.log[2]["loss"], "resumed": resumed.log[0]["loss"]}
    return {
        "config": cfg.name, "device": str(saved4["params"]["embed"].device),
        "saved_4_equals_state": same(saved4, {"params": whole.params, "opt": whole.opt}),
        "saved_2_equals_state": same(saved2, {"params": half.params, "opt": half.opt}),
        "restored_are_leaf_params": all(
            p.is_leaf and p.requires_grad and p.device.type == dev.type
            for p in tree_flatten(saved2["params"])[0]),
        "resume_line": "[resume] step 2 from" in text,
        "resumed_steps": [r["step"] for r in resumed.log],
        "resumed_count": int(resumed.opt.count), "step3_loss": loss3,
        "step3_rel_err": abs(loss3["resumed"] - loss3["whole"]) / abs(loss3["whole"]),
        "sigterm_exit": isinstance(term, SystemExit) and term.code == 1,
        "sigterm_line": "[sigterm] emergency checkpoint at step 3" in term_text,
        "sigterm_checkpoint": [found[0], int(saved_t["opt"].count)] if found else None}


def phase_launch_train(dev) -> dict:
    """Phase launch_train: the launcher's loop (``launch.train.train``) at
    full width on one 4096-token sequence, 3 steps for each configuration
    of ``LAUNCH_LAYERS`` (whisper's batch carries its frames); then the
    checkpoint mechanics at the smoke size of ``MECHANICS_ARCHS``."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launcher
    rows = []
    ops.reset_counts()
    for arch, layers in LAUNCH_LAYERS.items():
        cfg = cut_config(arch, layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run, _ = launch_quiet(launcher.train, cfg, steps=LAUNCH_STEPS, batch=1,
                              seq=LAUNCH_SEQ, log_every=1, device=dev)
        peak = torch.cuda.max_memory_allocated()
        timed = run.log[1:]                     # after the warm-up step
        step_s = sum(r["seconds"] for r in timed) / len(timed)
        rows.append({"config": cfg.name, "layers": layers,
                     "params": cfg.param_count(), "seq": LAUNCH_SEQ,
                     "log": run.log, "step_s": step_s,
                     "tokens_per_s": LAUNCH_SEQ / step_s,
                     "optimizer_count": int(run.opt.count),
                     "max_memory_allocated": peak})
        del run
        torch.cuda.empty_cache()
    launches = ops.counts()
    mechs = [checkpoint_mechanics(dev, arch) for arch in MECHANICS_ARCHS]
    out = {"phase": "launch_train", "configs": rows, "checkpoint": mechs,
           "left_out": {"zamba2_1p2b": "its full-width gradient is NaN, as "
                        "the reference's (phase families, hybrid_gradient)"},
           "launches": launches}
    emit(out)
    for r in rows:
        require(all(math.isfinite(x["loss"]) and math.isfinite(x["grad_norm"])
                    for x in r["log"]) and len(r["log"]) == LAUNCH_STEPS
                and r["optimizer_count"] == LAUNCH_STEPS,
                f"launch_train {r['config']}: {LAUNCH_STEPS} steps, finite "
                "losses and grad norms")
    require(not any(launches.values()), "launch_train: no kernel of ours "
            "(no pod axis, no qsr)")
    for mech in mechs:
        what = f"launch_train {mech['config']}"
        require(mech["saved_4_equals_state"] and mech["saved_2_equals_state"],
                f"{what}: checkpoints hold the saved state bit for bit")
        require(mech["restored_are_leaf_params"], f"{what}: restored params "
                "are leaf tensors on the card that require grad")
        require(mech["resume_line"] and mech["resumed_steps"] == [3, 4]
                and mech["resumed_count"] == 4, f"{what}: resume from step 2 "
                "runs steps 3-4 and the optimizer count reaches 4")
        require(mech["step3_rel_err"] <= 1e-3, f"{what}: the resumed step 3 "
                "loss within rtol 1e-3 of the uninterrupted run's")
        require(mech["sigterm_exit"] and mech["sigterm_line"]
                and mech["sigterm_checkpoint"] == [3, 3],
                f"{what}: SIGTERM inside step 3 leaves its checkpoint")
    return out


def dryrun_real_step(dev) -> dict:
    """Phase train's cell as the sharded step on a 1 x 1 mesh (a fake
    group of one rank: no collective runs): once on the card with real
    weights and a real batch under the dry run's counter, then timed
    without it, then through ``lower_cell`` on fake tensors."""
    from repro_torch.data.synth import batch_at
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shapes import ShapeCell
    from repro_torch.models.arch import init_params
    cfg = train_config()
    cell = ShapeCell("train_4k_1x4096", "train", TRAIN_SEQ, 1)
    with dryrun.fake_group(1):
        mesh = make_host_mesh(1, 1, device_type="cuda")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, 0, device=dev)
        batch = batch_at(cfg, 0, batch=1, seq=TRAIN_SEQ, device=dev)
        fn, state = dryrun.build_cell(cfg, cell, mesh, params=params,
                                      inputs=batch)
        del params
        real = dryrun.trace_step(fn, state)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        step_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            _, _, metrics = fn()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        loss = float(metrics["loss"])
        del fn, state, batch, metrics
        torch.cuda.empty_cache()
        fake, meta = dryrun.lower_cell(cfg, cell, mesh)
    dry_peak = fake.mem["args"] + fake.mem["temp"]
    best = min(step_ms)
    return {"config": cfg.name, "layers": cfg.n_layers, "tokens": TRAIN_SEQ,
            "flops_real": real.flops, "flops_dryrun": fake.flops,
            "hbm_bytes_real": real.hbm_bytes, "hbm_bytes_dryrun": fake.hbm_bytes,
            "collectives": len(real.collectives) + len(fake.collectives),
            "peak_bytes_real": peak, "peak_bytes_dryrun": dry_peak,
            "mem_dryrun": fake.mem, "mem_ratio": dry_peak / peak,
            "step_ms": step_ms, "loss": loss,
            "achieved_tflops": real.flops / (best / 1e3) / 1e12,
            "share_of_989": real.flops / (best / 1e3) / H100_PEAK_FLOPS,
            "dryrun_s": meta["t_compile_s"]}


def phase_dryrun(dev, smi: str) -> dict:
    """(a) The production cells of ``DRYRUN_CELLS`` through the dry run's
    parallel runner (``launch.dryrun.run_cells``, the CLI's ``--jobs``:
    one CLI process a cell, all at once), then (b) ``dryrun_real_step``
    holds the counter against a real step on the card; both must
    pass."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    records = dryrun.run_cells(DRYRUN_CELLS, device="cuda",
                               jobs=len(DRYRUN_CELLS), timeout=600)
    cells_s = time.perf_counter() - t0
    real = dryrun_real_step(dev)
    cells, failed = [], []
    for (arch, shape, mesh), r in zip(DRYRUN_CELLS, records):
        if r["status"] != "ok":
            failed.append(dict(arch=arch, shape=shape, mesh=mesh, **{
                k: r.get(k) for k in ("status", "error", "reason", "trace")}))
            continue
        cells.append({k: r[k] for k in (
            "arch", "shape", "mesh", "chips", "status", "depth_corrected",
            "flops_per_device", "hbm_bytes_per_device",
            "coll_wire_bytes_per_chip", "coll_by_kind", "bytes_per_device",
            "t_comp", "t_mem", "t_coll", "bottleneck", "useful_ratio",
            "constants", "t_lower_s", "t_compile_s")})
    out = {"phase": "dryrun", "nvidia_smi": smi, "cells": cells,
           "failed": failed, "cells_s": cells_s, "real_step": real}
    emit(out)
    require(not failed, f"dryrun: every cell ok ({len(failed)} failed)")
    require(real["collectives"] == 0, "dryrun: a 1 x 1 mesh runs no collective")
    require(real["flops_real"] == real["flops_dryrun"] > 0,
            "dryrun: the dry run's FLOPs equal the real step's")
    require(abs(real["mem_ratio"] - 1) <= DRYRUN_MEM_BAND,
            f"dryrun: the dry run's peak within {DRYRUN_MEM_BAND:.0%} of the "
            f"real step's (ratio {real['mem_ratio']:.4f})")
    require(math.isfinite(real["loss"]), "dryrun: the real step's loss is finite")
    return out


def kernel_summary(checks: dict, runs: dict, train: dict,
                   sweeps: dict, dist: dict) -> dict:
    """The ``kernels`` line: every TPU kernel, each at its main-path
    entry. The fluid pair's entries are the fused ``monitor_tick`` and
    ``route_arrivals`` at testbed8's shape (lcmp, the row with the most
    arrivals) and ``decide`` at wan2000's (lcmp, every flow, the
    failover's read), with their launches summed over the runs of
    phases run and packet, the groups of phases sweep, packet_sweep and
    cosim and the workers of phase sweep_mesh; the standalone
    ``cong_update`` and ``lcmp_decide`` entries stand beside them,
    launched by phase switch (``core.switchd``) and timed at its
    shapes."""
    runs = {**runs, **{f"sweep/{g}": r for g, r in sweeps.items()}}
    meta = {"monitor_tick": ("src/repro_torch/kernels/csrc/cong_update.cu",
                             "src/repro/kernels/cong_update.py:74", "cong_update"),
            "route_arrivals": ("src/repro_torch/kernels/csrc/lcmp_decide.cu",
                               "src/repro/kernels/lcmp_decide.py:93", "lcmp_decide"),
            "decide": ("src/repro_torch/kernels/csrc/lcmp_decide.cu",
                       "src/repro/kernels/lcmp_decide.py:93", "lcmp_decide")}
    out = []
    for name, (source, replaces, standalone) in meta.items():
        fields = kernel_fields(checks[name])
        cases = checks.get(f"{name}_cases", [])
        if cases:
            fields["max_abs_err"] = max(fields["max_abs_err"],
                                        max(r["max_abs_err"] for r in cases))
        alone = checks[standalone][0]
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(r["launches"][name] for r in runs.values()),
            "launches_by_run": {run: r["launches"][name]
                                for run, r in runs.items()},
            **fields, "host_us": checks[name][0]["host_us"],
            "standalone": {"name": standalone,
                           "launches": sum(r["launches"][standalone]
                                           for r in runs.values()),
                           **{k: alone[k] for k in ("shape", "ms", "plain_ms",
                                                    "call_ms", "bound_ms")}}})
    # the qsr pair at the train phase's first-leg shape (every pod's
    # padded gradient; the dequant of the received partials and of the
    # gathered mean have the same length), launched by the 3 int8 steps
    # and, in phase dist, by each rank's int8 reduce and step
    for name, replaces in (("qsr_int8", "src/repro/kernels/qsr_int8.py:41"),
                           ("qsr_dequant", "src/repro/kernels/qsr_int8.py:65")):
        by_run = {"train/lcmp_int8 x3": train["launches"][name],
                  **{f"dist/rank{r['rank']}": r["launches"][name]
                     for r in dist["per_rank"]}}
        out.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/qsr_int8.cu",
            "replaces": replaces, "launches": sum(by_run.values()),
            "launches_by_run": by_run, **kernel_fields(checks[name])})
    return {"kernels": out}


def kernel_fields(rows: list) -> dict:
    """The timing fields of a kernel's line, from its first (main-path)
    shape, with every checked shape beside them."""
    main = rows[0]
    return {"max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "shape": main["shape"],
            "call_ms": main["call_ms"], "plain_call_ms": main["plain_call_ms"],
            **{k: main[k] for k in STAGE_MS if k in main},
            "shapes": [{k: r[k] for k in ("shape", "ms", "plain_ms", "call_ms",
                                          "bound_ms", "bound_by", *STAGE_MS)
                        if k in r}
                       for r in rows]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    info = phase_device()
    phase_build()
    phase_lint(dev)
    checks = phase_kernel_check(dev, main_path_shapes(dev))
    runs = phase_runs(dev)
    packet_runs = phase_packet(dev)
    phase_profile(dev)
    with start_mesh_workers(dev) as workers:
        sweeps = phase_sweep(dev, runs)
        mesh = phase_sweep_mesh(dev, sweeps, workers)
    fidelity = phase_packet_sweep(dev, packet_runs)
    phase_sanitize(dev)
    cosim = phase_cosim(dev)
    switch = phase_switch(dev)
    phase_device_vs_cpu(dev)
    train = phase_train(dev)
    phase_train_device_vs_cpu(dev)
    dist = phase_dist(dev, train)
    phase_families(dev)
    phase_serve(dev)
    phase_launch_train(dev)
    phase_dryrun(dev, info["nvidia_smi"])
    emit(kernel_summary(checks, {**runs, **packet_runs, "cosim": cosim,
                                 "switch": switch, "sweep_mesh": mesh}, train,
                        {**sweeps, **fidelity}, dist))
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
