"""Port parity and contracts of the dry run (``launch.dryrun``) and
``shapes.input_specs``.

- ``input_specs`` equals the reference's stand-ins leaf for leaf (shape
  and dtype) for the ten configurations and four shapes, and
  ``init_cache(..., device="meta")`` the CPU cache's shapes;
- each cell's model FLOPs and skip record equal the reference's, and
  the parallel runner keeps the cells' order and fails a late cell;
- ``_depth_points`` and ``_extrapolate`` equal the reference's, which
  one subprocess imports (``repro.launch.dryrun`` sets ``XLA_FLAGS`` to
  512 host devices when imported, so never in a test worker);
- ``StepCounter`` counts each local op once (DTensor's own dispatch and
  its shape propagation on global shapes are not counted again);
- at smoke size the counts of two cut depths extrapolate exactly to the
  full depth's;
- ``args`` are the local shard bytes that ``Rules.param_specs`` gives,
  with the optimizer's moments and the batch;
- a smoke train, prefill and decode cell on a fake (2, 2) CPU mesh: rank
  0's FLOPs times 4 equal the same step's on one device, since at this
  size the rules leave no matmul replicated.

One fake process group of 4 ranks serves the module.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as rconfigs
from repro.launch import roofline as rrl
from repro.launch import shapes as rshapes
from repro_torch import configs
from repro_torch.launch import dryrun as D
from repro_torch.launch import shapes
from repro_torch.serve.decode import init_cache

SMOKE = dict(seq=16, batch=4)           # a cell's size on the (2, 2) mesh

_REF_DEPTH = r"""
import json, sys
from repro import configs
from repro.launch import dryrun
pts = [{"k": 1_234_567 + 7_654_321 * i + 3 * i * i, "w": 0.5 + 1.25 * i}
       for i in range(3)]
out = {}
for a in configs.ARCH_IDS:
    cfg = configs.get(a)
    dp = dryrun._depth_points(cfg)
    out[a] = dict(points=[[c.n_layers, c.n_enc_layers] for c in dp],
                  k=dryrun._extrapolate(cfg, pts[:len(dp)], "k"),
                  w=dryrun._extrapolate(cfg, pts[:len(dp)], "w"))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def mesh():
    """A (data 2, model 2) mesh over a fake group of 4 CPU ranks."""
    from repro_torch.launch.mesh import make_host_mesh
    with D.fake_group(4):
        yield make_host_mesh(2, 2, device_type="cpu")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, path + (k,)))
        return out
    return {path: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


def _ref_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(k.key for k in path): (tuple(x.shape), str(x.dtype))
            for path, x in flat}


def _cell(kind, seq=SMOKE["seq"], batch=SMOKE["batch"]):
    return shapes.ShapeCell("smoke_" + kind, kind, seq, batch)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_input_specs_equal_reference(arch):
    cfg, rcfg = configs.get(arch), rconfigs.get(arch)
    for name, cell in shapes.SHAPES.items():
        got = shapes.input_specs(cfg, cell)
        want = rshapes.input_specs(rcfg, rshapes.SHAPES[name])
        assert all(t.device.type == "meta" for t in
                   jax.tree.leaves(got, is_leaf=torch.is_tensor))
        assert _leaves(got) == _ref_leaves(want), (arch, name)


def test_init_cache_on_meta_has_the_cpu_shapes():
    for arch in configs.ARCH_IDS:
        cfg = configs.get(arch, smoke=True)
        meta = init_cache(cfg, 2, 16, device="meta")
        cpu = init_cache(cfg, 2, 16, device="cpu")
        assert _leaves(meta) == _leaves(cpu), arch


def test_model_flops_and_skip_records_equal_reference():
    for arch in configs.ARCH_IDS:
        rcfg = rconfigs.get(arch)
        for name, cell in shapes.SHAPES.items():
            n, tokens = rcfg.active_param_count(), cell.batch * cell.seq
            want = {"train": rrl.model_flops_train(n, tokens),
                    "prefill": rrl.model_flops_train(n, tokens) / 3,
                    "decode": rrl.model_flops_decode(n, cell.batch)}[cell.kind]
            got = D._meta(configs.get(arch), cell, 256)
            assert got["model_flops"] == want, (arch, name)
            reason = rshapes.skip_reason(rcfg, name)
            want_rec = reason and dict(arch=arch, shape=name, mesh="single",
                                       status="skip", reason=reason)
            assert D.skip_record(arch, name, "single") == want_rec


def test_parallel_runner_keeps_order_and_skips_and_fails_a_late_cell():
    """``run_cells`` with ``jobs`` > 1 (the CLI's ``--jobs``) returns the
    records in the cells' order, a skip record without starting a
    process, and a cell's process that runs past the time limit killed
    and its record failed."""
    cells = [("qwen3_4b", "long_500k", "single"),
             ("qwen3_4b", "decode_32k", "multi")]
    got = D.run_cells(cells, device="cpu", jobs=2, timeout=0.5)
    assert got[0] == D.skip_record(*cells[0])
    assert got[1]["status"] == "fail"
    assert got[1]["error"] == "timed out after 0.5 s"
    assert (got[1]["arch"], got[1]["shape"], got[1]["mesh"]) == cells[1]


def test_depth_points_and_extrapolation_equal_reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF_DEPTH], env=env,
                         capture_output=True, text=True, check=True,
                         timeout=240).stdout
    want = json.loads(out.strip().splitlines()[-1])
    pts = [{"k": 1_234_567 + 7_654_321 * i + 3 * i * i, "w": 0.5 + 1.25 * i}
           for i in range(3)]
    for arch in configs.ARCH_IDS:
        cfg = configs.get(arch)
        dp = D._depth_points(cfg)
        assert [[c.n_layers, c.n_enc_layers] for c in dp] == \
            want[arch]["points"]
        for key in ("k", "w"):
            assert D._extrapolate(cfg, pts[:len(dp)], key) == want[arch][key]


def test_local_ops_are_counted_once(mesh):
    """A Shard(0) (64 x 32) @ Replicate (32 x 16) on 4 ranks: each rank
    multiplies its 16 rows, 2 * 16 * 32 * 16 FLOPs. Counting the DTensor
    op with its global shapes as well would give 65,536 more."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    line = init_device_mesh("cpu", (4,))
    with FakeTensorMode():
        a = distribute_tensor(torch.empty(64, 32), line, [Shard(0)],
                              src_data_rank=None)
        b = distribute_tensor(torch.empty(32, 16), line, [Replicate()],
                              src_data_rank=None)
        c = D.StepCounter()
        with c:
            y = a @ b
    assert y.placements == (Shard(0),)
    assert c.flops == 2 * 16 * 32 * 16
    assert c.hbm_bytes == (16 * 32 + 32 * 16 + 16 * 16) * 4
    assert c.collectives == []


def test_depth_extrapolation_is_exact(mesh):
    cases = [(dataclasses.replace(configs.get("qwen3_4b", smoke=True),
                                  n_layers=4), _cell("train")),
             (dataclasses.replace(configs.get("whisper_medium", smoke=True),
                                  n_layers=3, n_enc_layers=3),
              _cell("prefill"))]
    for cfg, cell in cases:
        fit = D.run_cell(cfg, cell, mesh)
        full = D.run_cell(cfg, cell, mesh, depth_correction=False)
        assert fit["depth_corrected"] and not full["depth_corrected"]
        assert isinstance(full["flops_per_device"], int)
        for key in ("flops_per_device", "hbm_bytes_per_device",
                    "coll_wire_bytes_per_chip"):
            assert fit[key] == full[key], (cfg.name, key)
        assert fit["bytes_per_device"]["args"] == \
            full["bytes_per_device"]["args"]


def _local_numel(shape, spec, sizes):
    n = 1
    for dim, entry in zip(shape, spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n *= dim // math.prod(sizes[a] for a in axes)
    return n


def _zip_leaves(tree, specs, fn) -> list:
    """``fn(leaf, spec)`` for each leaf of a nested dict and its spec."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _zip_leaves(tree[k], specs[k], fn)]
    return [fn(tree, specs)]


def _plain_flops(cfg, cell):
    """The cell's step on one device (plain tensors) under the counter."""
    from repro_torch.models.arch import forward, param_shapes
    from repro_torch.serve.decode import decode_step
    from repro_torch.train.optim import adamw_init
    from repro_torch.train.step import TrainConfig, make_train_step
    with FakeTensorMode():
        params = D._empty_tree(param_shapes(cfg), "cpu")
        ins = shapes.input_specs(cfg, cell, device="cpu")
        if cell.kind == "train":
            for p in jax.tree.leaves(params, is_leaf=torch.is_tensor):
                p.requires_grad_()
            step, opt = make_train_step(cfg, TrainConfig()), adamw_init(params)
            fn = lambda: step(params, opt, ins)
        elif cell.kind == "prefill":
            fn = torch.no_grad()(lambda: forward(params, cfg, ins["tokens"]))
        else:
            fn = lambda: decode_step(params, cfg, ins["cache"], ins["tokens"],
                                     ins["pos"])
        return D.trace_step(fn, (params, ins)).flops


def test_smoke_cells_on_a_2x2_mesh(mesh):
    from repro_torch.dist.mesh_rules import make_rules
    from repro_torch.models.arch import param_shapes
    cfg = configs.get("qwen3_4b", smoke=True)
    sizes = {"data": 2, "model": 2}
    for kind in ("train", "prefill", "decode"):
        cell = _cell(kind)
        trace, meta = D.lower_cell(cfg, cell, mesh)
        assert meta["chips"] == 4
        rec = D.analyze(trace, meta)
        assert rec["constants"] == "h100-sxm" and rec["t_comp"] > 0
        # the rules shard every matmul of this cell: no FLOP is repeated
        assert trace.flops * 4 == _plain_flops(cfg, cell), kind
        assert trace.wire_bytes > 0 and trace.mem["temp"] > 0
        if kind != "train":
            continue
        tree = D._empty_tree(param_shapes(cfg), "meta")
        local = sum(_zip_leaves(tree, make_rules(cfg, mesh).param_specs(tree),
                                lambda t, spec: _local_numel(t.shape, spec,
                                                             sizes)))
        # params, mu, nu (float32), the count, and the whole batch's
        # tokens and labels (each rank takes the global batch and keeps
        # its rows)
        tokens = cell.batch * cell.seq
        assert trace.mem["args"] == 3 * 4 * local + 4 + 2 * 4 * tokens
