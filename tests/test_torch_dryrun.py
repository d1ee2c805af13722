"""The port's dry run against the JAX package's: analytic model FLOPs for
every arch and shape; for a SMOKE cell of each kind on a (data, model) =
(2, 2) mesh, the IR's dot FLOPs, collective records, wire bytes and the
argument bytes; the count-mode trace against the same program unrolled; the
weight-gather plan; and the ``skipped`` artifact of a ``skip_reason`` cell.
The JAX side runs in a subprocess: ``repro.launch.dryrun`` sets
``XLA_FLAGS`` for 512 host devices when it is imported."""
import collections
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, EXTRA_IDS, SHAPES, ShapeSpec  # noqa: E402
from repro_torch.core.trace import trace_sharded  # noqa: E402
from repro_torch.launch import analysis, dryrun  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.parallel.sharding import is_spec, param_specs  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
MESH = {"data": 2, "model": 2}
# SMOKE cells cut to a few tokens: (seq_len, global_batch) for each shape
CUT = {"train_4k": (64, 8), "prefill_32k": (64, 4), "decode_32k": (64, 4)}
# (An SSM cell differs: the JAX trace keeps the SSD scan's unused final
# state, two dot_generals a layer in the forward and their backward, where
# make_fx drops dead code; the count-mode test below covers the SSD loop.)
CELLS = [("qwen3_4b", "train_4k", {}), ("qwen3_4b", "prefill_32k", {}),
         ("qwen3_4b", "decode_32k", {}), ("llama3_8b", "decode_32k", {"gather_weights": True})]

_JAX = r"""
import json, os, sys
import repro.launch.dryrun as d  # sets XLA_FLAGS for 512 devices at import
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from repro.configs import get_config
from repro.configs.base import ARCH_IDS, EXTRA_IDS, SHAPES, ShapeSpec
from repro.launch import analysis
from repro.parallel.sharding import param_specs
from repro.models import Model
from repro.parallel.ctx import ParallelCtx

req = json.loads(sys.argv[1])
out = {"flops": {f"{a}/{s}": d.model_flops_per_device(get_config(a), s, 256)
                 for a in ARCH_IDS + EXTRA_IDS for s in SHAPES}}
cfg = get_config("llama3_8b")
shapes = jax.eval_shape(Model(cfg, ParallelCtx.single()).init, jax.random.PRNGKey(0))
pspecs = param_specs(shapes)
plan = d._weight_gather_plan(shapes, pspecs, 16)
spec_leaves = jax.tree_util.tree_leaves(d._apply_gather_specs(pspecs, shapes, plan),
                                        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
out["plan"] = jax.tree_util.tree_leaves(plan)
out["gather_specs"] = [[e if e is None or isinstance(e, str) else list(e) for e in s]
                       for s in spec_leaves]
for k, (s, b) in req["cut"].items():
    SHAPES[k] = ShapeSpec(k, s, b, SHAPES[k].kind)
d.get_config = lambda arch: get_config(arch, smoke=True)
mesh = jax.make_mesh((2, 2), ("data", "model"))
out["cells"] = []
for arch, shape, kw in req["cells"]:
    _, _, fn, avals, sizes = d.build_cell(arch, shape, mesh, **kw)
    ir = analysis.collect_ir_stats(fn, avals, sizes)
    with mesh:
        mem = jax.jit(fn).lower(*avals).compile().memory_analysis()
    out["cells"].append({"ir_dot_flops": ir["ir_dot_flops"],
                         "collective_wire_bytes": ir["collective_wire_bytes"],
                         "collectives": ir["collectives"],
                         "argument_bytes": mem.argument_size_in_bytes})
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_side():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC))
    req = json.dumps({"cut": CUT, "cells": CELLS})
    res = subprocess.run([sys.executable, "-c", _JAX, req], env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture
def smoke(monkeypatch):
    """SMOKE configs in the dry run's cells, as the JAX side patches its own."""
    monkeypatch.setattr(dryrun, "get_config", lambda arch: get_config(arch, smoke=True))


@pytest.fixture
def cut_shapes(monkeypatch, smoke):
    for k, (s, b) in CUT.items():
        monkeypatch.setitem(SHAPES, k, ShapeSpec(k, s, b, SHAPES[k].kind))


def _record(c):
    return (c["op"], tuple(c["axes"]), c["n"], tuple(c["shape"]), c["dtype"], c["mult"],
            c["payload_bytes"], c["wire_bytes"])


def test_model_flops_match_jax(jax_side):
    for arch in ARCH_IDS + EXTRA_IDS:
        for shape in SHAPES:
            got = dryrun.model_flops_per_device(get_config(arch), shape, 256)
            assert got == jax_side["flops"][f"{arch}/{shape}"], (arch, shape)


@pytest.mark.parametrize("i", range(len(CELLS)))
def test_smoke_cell_counts_match_jax(i, jax_side, cut_shapes):
    """Dot FLOPs, every collective record (op, axes, group size, shape,
    dtype, multiplicity, bytes) and the per-device argument bytes."""
    arch, shape, kw = CELLS[i]
    cell = dryrun.build_cell(arch, shape, MESH, **kw)
    got, want = dryrun.cell_ir_stats(cell), jax_side["cells"][i]
    assert got["ir_dot_flops"] == want["ir_dot_flops"]
    assert got["collective_wire_bytes"] == want["collective_wire_bytes"]
    assert (collections.Counter(map(_record, got["collectives"]))
            == collections.Counter(map(_record, want["collectives"])))
    assert dryrun.cell_memory(cell)["argument_bytes"] == want["argument_bytes"]


@pytest.mark.parametrize("arch,shape,cut", [
    ("qwen3_4b", "train_4k", (64, 8)),        # 2 microbatches x 2 layers
    ("qwen3_4b", "prefill_32k", (2048, 4)),   # 2 attention chunks a layer
    ("mamba2_130m", "prefill_32k", (512, 4)),  # 4 SSD chunks a layer
])
def test_count_mode_equals_unrolled(arch, shape, cut, monkeypatch, smoke):
    """The one-iteration-times-``mult`` trace counts what the program
    traced with every loop unrolled in Python counts."""
    monkeypatch.setitem(SHAPES, shape, ShapeSpec(shape, *cut, SHAPES[shape].kind))
    cell = dryrun.build_cell(arch, shape, MESH)
    counted = dryrun.cell_ir_stats(cell)
    parts = [analysis.ir_stats(trace_sharded(ph.fn, MESH, ph.in_specs, *ph.avals,
                                             grad=ph.grad, ctx_kw=cell.ctx_kw)[0], MESH)
             for ph in cell.phases]
    assert all(c["mult"] == 1 for p in parts for c in p["collectives"])
    assert sum(p["ir_nodes"] for p in parts) > counted["ir_nodes"]
    for key in ("ir_dot_flops", "collective_wire_bytes", "collective_payload_bytes"):
        assert counted[key] == sum(p[key] for p in parts), key

    def volume(colls):
        out = collections.Counter()
        for c in colls:
            out[(c["op"], tuple(c["axes"]), tuple(c["shape"]))] += c["mult"]
        return out
    assert volume(counted["collectives"]) == volume(
        [c for p in parts for c in p["collectives"]])


def test_weight_gather_plan_matches_jax(jax_side):
    cfg = get_config("llama3_8b")
    shapes = Model(cfg, impl="reference", device="cpu").param_shapes()
    pspecs = param_specs(shapes)
    plan = dryrun._weight_gather_plan(shapes, pspecs, 16)
    assert tree_leaves(plan) == jax_side["plan"]
    specs = tree_leaves(dryrun._apply_gather_specs(pspecs, shapes, plan), is_leaf=is_spec)
    assert [[e if e is None or isinstance(e, str) else list(e) for e in s]
            for s in specs] == jax_side["gather_specs"]


def test_main_writes_skipped_artifact(tmp_path, capsys):
    dryrun.main(["--arch", "qwen3_4b", "--shape", "long_500k", "--out", str(tmp_path)])
    art = json.loads((tmp_path / "qwen3_4b--long_500k--16x16.json").read_text())
    assert art["status"] == "skipped" and "500k" in art["skip_reason"]
    assert "[skipped] qwen3_4b long_500k" in capsys.readouterr().out


def test_roofline_uses_the_h100_model():
    ir = {"ir_dot_flops": 989e12, "ir_ew_flops": 0, "ir_hbm_bytes": 3.35e12,
          "ir_kernel_saved_bytes": 3.35e12, "collective_s": 0.5}
    roof = analysis.roofline_terms(ir, model_flops_per_device=989e12)
    assert roof["compute_s"] == roof["memory_s"] == 1.0 and roof["memory_s_pallas"] == 0
    assert roof["useful_flop_ratio"] == 1.0 and roof["bound_s_pallas"] == 1.0
    # the model axis of the 16x16 mesh spans 16 GPUs: InfiniBand; 8: NVLink
    assert analysis.link_bw(("model",), {"data": 16, "model": 16}) == analysis.IB_BW
    assert analysis.link_bw(("model",), {"data": 32, "model": 8}) == analysis.NVLINK_BW
    assert analysis.link_bw(("data",), {"data": 2, "model": 4}) == analysis.NVLINK_BW


def test_memory_estimate_equals_memtracker_on_real_tensors():
    """The fake run's peak is what ``MemTracker`` reads over the same step
    on real tensors (a SMOKE train step on the CPU)."""
    import torch
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.configs import input_specs
    from repro_torch.configs.base import ShapeDtype
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.trainer import TrainConfig, make_step_fn

    cfg = get_config("qwen3_4b", smoke=True)
    model = Model(cfg, impl="reference", device="cpu")
    step = make_step_fn(model, TrainConfig(opt=AdamWConfig(), remat=False))
    params = model.param_shapes()
    batch = input_specs(cfg, ShapeSpec("train", 64, 4, "train"))
    opt = {"m": dryrun._f32_like(params), "v": dryrun._f32_like(params),
           "step": ShapeDtype((), torch.int32)}
    est = dryrun.memory_estimate(step, (params, opt, batch), grad=True)

    real = model.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    tokens = {k: torch.randint(0, cfg.vocab, v.shape, generator=gen, dtype=v.dtype)
              for k, v in batch.items()}
    state = adamw_init(real)
    tracker = MemTracker()
    tracker.track_external(real, state, tokens)
    with tracker:
        step(real, state, tokens)
    peak = sum(d["Total"] for d in tracker.get_tracker_snapshot("peak").values())
    assert est["peak_bytes"] == peak
    assert est["temp_bytes"] == peak - est["argument_bytes"] > 0


def test_memory_estimate_counts_an_argument_written_in_place_once():
    """An op that writes an argument in place returns a view of it: the
    estimate counts its storage once (as AdamW's in-place slices of the
    parameters and moments), so a function that only scales its argument
    in place peaks at the argument's bytes."""
    import torch

    from repro_torch.configs.base import ShapeDtype

    def scale_in_place(w, m):
        for ws, ms in zip(torch.split(w, 4), torch.split(m, 4)):
            ms.mul_(0.9).add_(ws.float())
            ws.copy_(ms)
        return w

    est = dryrun.memory_estimate(scale_in_place, (ShapeDtype((16, 64), torch.bfloat16),
                                                  ShapeDtype((16, 64), torch.float32)),
                                 grad=False)
    assert est["argument_bytes"] == 16 * 64 * 6
    # the peak: the arguments and one slice's f32 conversion
    assert est["peak_bytes"] == est["argument_bytes"] + 4 * 64 * 4


def test_memory_peak_repeats_after_three_microbatches(monkeypatch, smoke):
    """The memory run's three microbatches give the peak all of them give
    (a SMOKE train cell, 5 microbatches a rank)."""
    import repro_torch.scope as scope

    monkeypatch.setitem(SHAPES, "train_4k", ShapeSpec("train_4k", 64, 10, "train"))
    cell = dryrun.build_cell("qwen3_4b", "train_4k", MESH, micro=5)
    three = dryrun.cell_memory(cell)
    real_counting = scope.counting
    monkeypatch.setattr(scope, "counting", lambda loops, keep=1: real_counting(loops, 5))
    assert dryrun.cell_memory(cell)["peak_bytes"] == three["peak_bytes"]
    monkeypatch.setattr(scope, "counting", lambda loops, keep=1: real_counting(loops, 2))
    assert dryrun.cell_memory(cell)["peak_bytes"] < three["peak_bytes"]


def test_memory_peak_repeats_after_three_layers_and_chunks(monkeypatch):
    """A program that does not differentiate: three layers and three
    attention chunks give the peak all of them give (SMOKE prefill cut to
    5 layers, 5 chunks of 1024 keys)."""
    import dataclasses

    import repro_torch.scope as scope

    monkeypatch.setattr(dryrun, "get_config", lambda arch: dataclasses.replace(
        get_config(arch, smoke=True), n_layers=5))
    monkeypatch.setitem(SHAPES, "prefill_32k", ShapeSpec("prefill_32k", 5120, 2, "prefill"))
    cell = dryrun.build_cell("qwen3_4b", "prefill_32k", MESH)
    three = dryrun.cell_memory(cell)
    real_counting = scope.counting
    monkeypatch.setattr(scope, "counting", lambda loops, keep=1: real_counting(loops, 5))
    assert dryrun.cell_memory(cell)["peak_bytes"] == three["peak_bytes"]
