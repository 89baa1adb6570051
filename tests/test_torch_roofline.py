"""Port parity of ``launch.roofline``: the port's copy equals
``repro.launch.roofline`` bit for bit. ``_shape_bytes``, ``_group_size``
and ``parse_collectives`` read hypothesis-made HLO collective lines and
the optimized HLO of a small sharded jax function compiled on 8 host
devices (in a subprocess, which sets ``XLA_FLAGS`` before jax starts);
``roofline`` with the v5e constants, ``model_flops_train`` and
``model_flops_decode`` take the same numbers in both packages. The H100
constants are NVIDIA's data-sheet figures, under names of their own.
"""
import dataclasses
import os
import subprocess
import sys

from hypothesis import given, settings
from hypothesis import strategies as st

from repro.launch import roofline as ref
from repro_torch.launch import roofline as rl

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")
DTYPES = sorted(ref._DTYPE_BYTES) + ["token", "c64"]     # two it skips

_HLO = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
def f(x, w, v):
    h = jnp.tanh(x @ w)                          # contraction sharded: psum
    h = jax.lax.with_sharding_constraint(h, NamedSharding(mesh, P(None, "model")))
    y = h @ v
    return jax.lax.with_sharding_constraint(y, NamedSharding(mesh, P("model", None))), h.sum()
shard = lambda *s: NamedSharding(mesh, P(*s))
fn = jax.jit(f, in_shardings=(shard("data", "model"), shard("model", None),
                              shard("model", "data")))
args = (jnp.ones((64, 128), jnp.bfloat16), jnp.ones((128, 256), jnp.float32),
        jnp.ones((256, 32), jnp.float32))
sys.stdout.write(fn.lower(*args).compile().as_text())
"""


def _line(kind, sig_dims, dtype, tup, start, root, groups, g):
    shape = f"{dtype}[{','.join(map(str, sig_dims))}]{{0}}"
    sig = f"({shape}, {shape})" if tup else shape
    name = f"%{kind}.{g}"
    if groups == "list":
        rg = "replica_groups={{" + ",".join(map(str, range(g))) + "}}"
    elif groups == "iota":
        rg = f"replica_groups=[{max(8 // g, 1)},{g}]<=[8]"
    else:
        rg = "channel_id=3"
    op = kind + ("-start" if start else "")
    return (f"  {'ROOT ' if root else ''}{name} = {sig} {op}({shape} %p), "
            f"{rg}, to_apply=%add")


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(0, 4), min_size=1, max_size=6),
       st.lists(st.integers(0, 512), min_size=0, max_size=3),
       st.sampled_from(DTYPES), st.booleans(), st.booleans(),
       st.sampled_from(("list", "iota", "none")), st.integers(1, 8))
def test_parse_collectives_equals_reference(kinds, dims, dtype, tup, start,
                                            groups, g):
    lines = [_line(KINDS[k], dims, dtype, tup and i % 2 == 0, start,
                   i == len(kinds) - 1, groups, g)
             for i, k in enumerate(kinds)]
    lines.append("  %all-gather-done.1 = f32[8]{0} all-gather-done(%x)")
    text = "\n".join(lines)
    for line in lines:
        sig = line.split("=", 1)[1]
        assert rl._shape_bytes(sig) == ref._shape_bytes(sig)
        assert rl._group_size(line) == ref._group_size(line)
    assert dataclasses.asdict(rl.parse_collectives(text)) == \
        dataclasses.asdict(ref.parse_collectives(text))
    assert rl._scan_trip_count(text + " trip_count=7") == \
        ref._scan_trip_count(text + " trip_count=7")


def test_parse_compiled_hlo_equals_reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    text = subprocess.run([sys.executable, "-c", _HLO], capture_output=True,
                          text=True, check=True, env=env,
                          timeout=240).stdout
    got, want = rl.parse_collectives(text), ref.parse_collectives(text)
    assert want.num_ops > 0
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert rl.CollectiveStats.row(got) == ref.CollectiveStats.row(want)


@settings(max_examples=60, deadline=None)
@given(st.floats(0.0, 1e18), st.floats(0.0, 1e15), st.floats(0.0, 1e12),
       st.integers(1, 512), st.floats(0.0, 1e20), st.integers(1, 64),
       st.integers(1, 1 << 34), st.integers(1, 1 << 24))
def test_roofline_v5e_equals_reference(flops, nbytes, wire, chips, mflops,
                                       trips, n_active, tokens):
    cost = {"flops": flops, "bytes accessed": nbytes}
    got = rl.roofline(cost, rl.CollectiveStats({"all-reduce": 1.0}, wire, 1),
                      chips, mflops, trips)
    want = ref.roofline(cost, ref.CollectiveStats({"all-reduce": 1.0}, wire,
                                                  1), chips, mflops, trips)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.derived() == want.derived()
    assert rl.model_flops_train(n_active, tokens) == \
        ref.model_flops_train(n_active, tokens)
    assert rl.model_flops_decode(n_active, tokens) == \
        ref.model_flops_decode(n_active, tokens)


def test_constants():
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.ICI_BW) == \
        (ref.PEAK_FLOPS, ref.HBM_BW, ref.ICI_BW)
    assert (rl.V5E.peak_flops, rl.V5E.hbm_bw, rl.V5E.link_bw) == \
        (ref.PEAK_FLOPS, ref.HBM_BW, ref.ICI_BW)
    assert (rl.H100.peak_flops, rl.H100.hbm_bw, rl.H100.link_bw) == \
        (989e12, 3.35e12, 450e9)
    r = rl.roofline({"flops": 989e12, "bytes accessed": 3.35e12},
                    rl.CollectiveStats({}, 450e9, 0), 1, 0.0, chip=rl.H100)
    assert (r.t_comp, r.t_mem, r.t_coll) == (1.0, 1.0, 1.0)


def test_wire_bytes_are_the_ring_factors():
    n, g = 1 << 20, 16
    assert rl.wire_bytes("all-reduce", n, g) == 2.0 * (g - 1) / g * n
    assert rl.wire_bytes("all-gather", n, g) == (g - 1) / g * n
    assert rl.wire_bytes("reduce-scatter", n, g) == (g - 1) / g * n * g
    assert rl.wire_bytes("all-to-all", n, g) == (g - 1) / g * n
    assert rl.wire_bytes("collective-permute", n, g) == float(n)
