#!/usr/bin/env python3
"""Readings behind the bf16 limits of the SSM model tests.

tests/test_torch_model.py holds the port's bf16 SMOKE models that have SSD
layers (mamba2_130m and the jamba hybrid without experts) to the jitted JAX
model by relative RMS error, one limit per checked quantity.  This script
prints, for each quantity, the readings a limit must sit between:

- ``benign``: differences between correct programs on the test's inputs:
  the JAX model jitted against the JAX model eager, and the port against
  each of them;
- one entry per planted fault: the port, with that fault patched in for
  the run, against the jitted JAX model.

Quantities: forward logits; decode logits (largest over the 6 steps of the
test, at max_len 8); and after those steps each cache leaf, by name and
layer position (``k``/``v`` for the hybrid's attention layer).  Then, under
``positions``, the same benign readings for the decode step of
tests/test_torch_model.py::test_tensor_position_matches_int_and_jax: two
steps at positions 0 and 1, then one at position -3 (the write wraps once)
or 9 (past max_len 6: the write clamps), its logits and the caches after
it.  The faults are patched into this process only:

- ``conv_taps_reversed``: the causal conv applies its taps in reverse order
  (forward and decode);
- ``ungrouped_norm``: the gated RMSNorm normalises over the whole inner
  width instead of per SSD head;
- ``dskip_dropped``: the skip term ``Dskip * x`` is left out;
- ``state_not_decayed``: decode adds to the state without decaying it;
- ``conv_buffer_not_updated``: decode does not write its new conv inputs
  back to the cache (the trap that ``decode_step`` copies around).

Usage (from the repository root; about 1.5 min on the CPU):

    JAX_PLATFORMS=cpu python3 tests/ssm_bf16_tolerances.py
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch.configs import ArchConfig, get_config  # noqa: E402
from repro_torch.models import Model, model as model_mod, ssm  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402

ARCHS = ["mamba2_130m", "jamba_1_5_large-noexperts"]
STEPS, MAX_LEN = 6, 8


def configs(arch: str):
    if arch.endswith("-noexperts"):
        jcfg = dataclasses.replace(jax_config(arch.split("-")[0], smoke=True), n_experts=0)
        tcfg = ArchConfig(**dataclasses.asdict(jcfg))
    else:
        jcfg, tcfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    return (dataclasses.replace(jcfg, dtype="bfloat16"),
            dataclasses.replace(tcfg, dtype="bfloat16"))


def tokens(B, S, seed):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(np.int32)


def np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def rel(a, b) -> float:
    a, b = np32(a), np32(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def run_jax(jm, jp, jit: bool) -> dict:
    """Forward logits, decode logits per step and the caches after them."""
    ctx = contextlib.nullcontext() if jit else jax.disable_jit()
    with ctx:
        fwd = jax.jit(jm.forward) if jit else jm.forward
        step = jax.jit(jm.decode_step) if jit else jm.decode_step
        out = {"forward": np32(fwd(jp, {"tokens": jnp.asarray(tokens(2, 24, 0))}))}
        toks = tokens(2, STEPS, 2)
        cache = jm.init_cache(2, MAX_LEN)
        logits = []
        for t in range(STEPS):
            lg, cache = step(jp, jnp.asarray(toks[:, t]), cache, jnp.int32(t))
            logits.append(np32(lg))
    out["decode"] = logits
    out["cache"] = [{k: np32(v) for k, v in c.items()} for c in cache]
    return out


def run_port(tcfg, tp) -> dict:
    model = Model(tcfg, device="cpu")
    out = {"forward": np32(model.forward(
        tp, {"tokens": torch.from_numpy(tokens(2, 24, 0)).long()}))}
    toks = tokens(2, STEPS, 2)
    cache = model.init_cache(2, MAX_LEN)
    logits = []
    for t in range(STEPS):
        lg, cache = model.decode_step(tp, torch.from_numpy(toks[:, t]).long(), cache, t)
        logits.append(np32(lg))
    out["decode"] = logits
    out["cache"] = [{k: np32(v) for k, v in c.items()} for c in cache]
    return out


def position_step(step, init_cache, position: int) -> dict:
    """The position test's decode: positions 0, 1, then ``position``, with
    ``step(tokens, cache, position) -> (logits, cache)``; the last step's
    logits and the caches after it."""
    toks = tokens(2, 3, 4)
    cache = init_cache(2, 6)
    for t in range(2):
        _, cache = step(toks[:, t], cache, t)
    lg, cache = step(toks[:, 2], cache, position)
    return {"decode": [np32(lg)], "cache": [{k: np32(v) for k, v in c.items()}
                                             for c in cache]}


def position_readings(jm, jp, tcfg, tp) -> dict:
    """Benign readings of the position test's decode step (see the module
    docstring), by position."""
    model = Model(tcfg, device="cpu")
    jstep = jax.jit(jm.decode_step)
    out = {}
    for position in (-3, 9):
        jit = position_step(lambda t, c, q: jstep(jp, jnp.asarray(t), c, jnp.int32(q)),
                            jm.init_cache, position)
        with jax.disable_jit():
            eager = position_step(
                lambda t, c, q: jm.decode_step(jp, jnp.asarray(t), c, jnp.int32(q)),
                jm.init_cache, position)
        port = position_step(
            lambda t, c, q: model.decode_step(tp, torch.from_numpy(t).long(), c, q),
            model.init_cache, position)
        out[str(position)] = {"jax_jit_vs_eager": readings(eager, jit),
                              "port_vs_jax_jit": readings(port, jit),
                              "port_vs_jax_eager": readings(port, eager)}
    return out


def readings(got: dict, want: dict) -> dict:
    r = {"decode_logits": max(rel(a, b) for a, b in zip(got["decode"], want["decode"]))}
    if "forward" in want:
        r = {"forward_logits": rel(got["forward"], want["forward"]), **r}
    for j, (gc, wc) in enumerate(zip(got["cache"], want["cache"])):
        for name in wc:
            r[f"cache[{j}].{name}"] = rel(gc[name], wc[name])
    return r


@contextlib.contextmanager
def fault(name: str, tp):
    """Patch one fault into the port for the duration of the block."""
    saved = {}

    def patch(obj, attr, new):
        saved[(obj, attr)] = getattr(obj, attr)
        setattr(obj, attr, new)

    conv, decode, norm = ssm._causal_conv, ssm.ssm_decode, ssm.gated_rmsnorm
    blocks = [b["ssm"] for b in tp["blocks"] if "ssm" in b]
    dskip = [b["Dskip"].clone() for b in blocks]
    if name == "conv_taps_reversed":
        patch(ssm, "_causal_conv", lambda x, w: conv(x, w.flip(0)))

        def reversed_decode(cfg, ctx, p, x, cache):
            p = {**p, **{k: p[k].flip(0) for k in ("conv_x", "conv_B", "conv_C")}}
            return decode(cfg, ctx, p, x, cache)
        patch(model_mod, "ssm_decode", reversed_decode)
    elif name == "ungrouped_norm":
        patch(ssm, "gated_rmsnorm", lambda p, y, z, eps, group: norm(p, y, z, eps, group=0))
    elif name == "dskip_dropped":
        for b in blocks:
            b["Dskip"].zero_()
    elif name == "state_not_decayed":
        def undecayed_decode(cfg, ctx, p, x, cache):
            out, new = decode(cfg, ctx, p, x, cache)
            # what the state would be with decay 1: add back what it decayed away
            h = cache["state"]
            dt = F.softplus(ssm.linear(p["wdt"], x)[:, 0].float() + p["dt_bias"])
            decay = torch.exp(dt * -torch.exp(p["A_log"].float()))
            return out, {**new, "state": new["state"] + h * (1 - decay)[..., None, None]}
        patch(model_mod, "ssm_decode", undecayed_decode)
    elif name == "conv_buffer_not_updated":
        def stale_decode(cfg, ctx, p, x, cache):
            out, new = decode(cfg, ctx, p, x, cache)
            return out, {**new, **{k: cache[k].clone() for k in ("conv_x", "conv_B", "conv_C")}}
        patch(model_mod, "ssm_decode", stale_decode)
    else:
        raise ValueError(name)
    try:
        yield
    finally:
        for (obj, attr), v in saved.items():
            setattr(obj, attr, v)
        for b, d in zip(blocks, dskip):
            b["Dskip"].copy_(d)


FAULTS = ["conv_taps_reversed", "ungrouped_norm", "dskip_dropped", "state_not_decayed",
          "conv_buffer_not_updated"]


def main() -> int:
    for arch in ARCHS:
        jcfg, tcfg = configs(arch)
        jm = JaxModel(jcfg)
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        jit, eager = run_jax(jm, jp, True), run_jax(jm, jp, False)
        with torch.inference_mode():
            port = run_port(tcfg, tp)
            faulty = {}
            for name in FAULTS:
                with fault(name, tp):
                    faulty[name] = readings(run_port(tcfg, tp), jit)
        out = {"arch": arch, "dtype": "bfloat16",
               "benign": {"jax_jit_vs_eager": readings(eager, jit),
                          "port_vs_jax_jit": readings(port, jit),
                          "port_vs_jax_eager": readings(port, eager)},
               "faults_vs_jax_jit": faulty}
        with torch.inference_mode():
            out["positions"] = position_readings(jm, jp, tcfg, tp)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
