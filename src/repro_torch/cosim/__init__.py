"""Training/network co-simulation (counterpart of ``repro/cosim``): the
collective layer meets the netsim engines.

``workload`` turns a ``configs/`` model, a ``launch/shapes.py`` cell and
the ``dist.lcmp_collectives`` bucket schedule into deterministic
per-iteration reduce-scatter / all-gather flow bursts overlaid on the
Poisson background (``CosimPlan``, ``build_plan``, ``overlay``);
``iterate`` scores a run in training terms (per-iteration makespan under
barrier semantics, straggler attribution per route) and feeds measured
bucket times back into the collective layer's telemetry
(``feed_route_telemetry``). Host numpy code, as in the reference.
"""
from repro_torch.cosim.iterate import (IterStats, feed_route_telemetry,  # noqa: F401
                                       iteration_stats, pair_path_slots,
                                       straggler_routes)
from repro_torch.cosim.workload import CosimPlan, build_plan, overlay  # noqa: F401
