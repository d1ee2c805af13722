#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU: time every kernel and hold
every model path to its reference.

Run from the repository root on a machine with one H100:

    python3 chip_smoke.py

Phases, one JSON line each: device (name, capability, power limit, kernel
builds), kernel resources (each kernel's registers, stack and spills from
the ``nvcc -Xptxas -v`` log, and its dynamic shared memory), kernel
flash_attention, kernel rmsnorm, kernel ssd_scan, kernel causal_conv and
kernel skip_gated_norm (each kernel at the main paths' shapes of its table in
``tests/card_cases.py``, held to its plain version with the table's
tolerance and timed beside it and its bound; every row of those tables,
edge cases included, is checked by the card tests,
``JAX_PLATFORMS=cpu python -m pytest -q -m card tests/``), and
beside them, in a child process on the card's host, lint (the port's lint tier on four
dense archs at full width, 2 layers, tp 1, tp 4 and SP, finding-free; an
injected dropped all_reduce flagged at its line; the rule registry's
static check clean) and dryrun (three cells of the multi-pod dry run on
the 16x16 mesh at full depth, traced over fake tensors: per-device memory,
roofline terms under the H100 model, the train cell's useful-FLOP ratio at
most 1), then training, with grad enabled: train (qwen3_4b at full width and depth, bf16, 8 steps of the
trainer's step on the reference path, as the launcher trains: every
leaf's first gradient finite and nonzero, the first loss against the
kernel path's, s/step, tokens/s and peak memory), train_parity (one f32
step of qwen3_4b cut to 2 layers on the card and on its host, every
updated leaf and moment compared), tpdp_train (that step on four gloo
ranks sharing the card, data 2 x model 2, plain and ZeRO-1, against one
device at the JAX reference's bounds, and each rank's moments and gradient
norm against a plain first step from the ranks' local gradients; then the
same step sequence-parallel, its loss, moments and norm also held to the
TP step's) and train_launcher (the training
launcher at SMOKE size on tp 2 x dp 2 ranks: the verification gate, a
falling loss, checkpoint and resume, a sequence-parallel launch whose gate
proves the SP plan, the refused ``--zero1 --dp 2``);
then, under ``inference_mode``, for each model at full
width, with random weights from a seeded generator: prefill (through the
kernels, checked against the reference path) and serve (the engine answers
four requests; prefill logits are checked against the engine path's
``decode_step``; after qwen3_4b's, roofline: its train step's and its
prefill's measured times each at least the H100 roofline bound of the
port's IR counts, and the step's estimated peak memory beside the
measured).  The models are qwen3_4b, qwen1_5_4b (qkv biases),
chatglm3_6b (half-dim RoPE, 2 KV heads padded to 16) and gemma_2b (head dim
256, GeGLU, tied embeddings), all through flash attention, and mamba2_130m
(the SSD scan); then the frontends: hubert_xlarge (audio frames through 48
non-causal layers at head dim 80, GELU MLPs; prefill only: the serving
launcher must refuse the encoder with exit 1) and internvl2_26b (a
``vis_proj`` prefix of 256 patches before 768 tokens, 48 causal GQA layers;
prefill, then serve on text prompts); then the MoE archs: granite_moe_3b
(32 layers, 40 experts padded to 48, top 8; K1 at head dim 64; prefill
through the capacity dispatch, with the pairs capacity dropped and the
tokens whose top-k sets differ between the kernel and reference paths;
the dispatch against a plain per-expert loop; serve) and mixtral_8x7b cut
to 8 of its 32 layers (8 experts of width 14336, top 2; prefill and the
dispatch check), and moonshot_v1_16b whole (48 layers, 64 experts and a
shared expert, 53.8 GiB of bf16 weights whose expert stacks are drawn a
block at a time; prefill, with the peak device memory over init and
prefill).  Every prefill's inputs are named
and typed as ``input_specs`` gives them.  Then the verifier's main path:
verify (the port's ``Session`` proves, at full width and depth, tp-forward
and tp-decode at tp 4 for llama3_8b, qwen3_4b, mamba2_130m, qwen1_5_4b,
chatglm3_6b, gemma_2b and internvl2_26b, sp-forward at tp 4 for llama3_8b,
gemma_2b, hubert_xlarge and internvl2_26b, tp-forward at tp 4 for
hubert_xlarge and at tp 16 for llama3_70b and llama3_405b, dp-forward
at dp 2 for gemma_2b and llama3_8b, and the MoE plans: granite_moe_3b's
tp-forward, ep-moe-forward, tp-decode and sp-forward at 4, moonshot_v1_16b's
and mixtral_8x7b's tp-forward and ep-moe-forward at 4, mixtral_8x7b and
mixtral_8x22b at tp 16, jamba_1_5_large's tp-forward at 4, and four plans
of several scenarios: llama3_8b in 4 pipeline stages of TP 4 and TP 4 x DP
2 composite, llama3_405b in 2 stages of TP 16, granite_moe_3b in 2 stages
of TP 4; host seconds and memo hits beside the JAX reference's), campaign (every registered injector
on llama3_8b's tp4 tp-forward, tp-decode and sp-forward pairs, mamba2_130m's
tp-forward pair, gemma_2b's tp-forward and dp-forward pairs, hubert_xlarge's
tp-forward pair, internvl2_26b's sp-forward pair, and granite_moe_3b's and
mixtral_8x7b's tp-forward, tp-decode, sp-forward and ep-moe-forward pairs,
each cell's outcome, localization and lint flag held to the JAX
reference's),
dp_grad (the port's ``Session`` proves the gradient-sync contract,
``Plan.grad(dp=2)``, for llama3_8b and qwen3_4b at full width, 8 layers;
then ``spmd.dp_grad``, the program proved, runs on two gloo ranks sharing
the card, llama3_8b at full width with two layers in f32, each rank's
psummed gradient held leaf by leaf to the single device's full-batch
gradient), dp_forward (the verifier's dp-forward program on two gloo ranks sharing the
card, gemma_2b at full width and depth, flash attention on every layer of
every rank; each rank's logits held to its rows of the single-device
forward), tp_forward (the per-rank TP program the verifier
proves, run on four gloo ranks sharing the card, llama3_8b at full width
with two layers, then granite_moe_3b at full width with four layers, 12 of
its 48 experts a rank, flash attention on every layer of every rank;
logits gathered on rank 0 and held to the single-device model; the pairs
each rank's experts dropped beside the single device's; llama3_8b's ranks
then run the sequence-parallel program the verifier's sp-forward proves,
sp_forward, held to the single device and to the TP program), tp_decode (the
proved per-rank decode step on the same four ranks: a 32-token prompt fed
one position at a time, then 8 more steps; every step's logits and the
final KV cache shards held to the single-device ``decode_step``),
cp_decode (the decode step with the KV cache cut along the sequence over a
context-parallel axis, tp 2 x cp 2 on the same ranks: llama3_8b with two
layers, caches of 8192 positions filled by a one-device prefill of 4090
tokens, 12 steps whose write moves from the first sequence shard to the
second; every step's logits held to the single-device ``decode_step``),
tpdp_forward (the verifier's tp x dp program on the same four ranks as a
(data, model) = (2, 2) mesh, llama3_8b with two layers; each rank's rows
and vocab columns of the logits held to the single device's),
pipeline_forward (llama3_8b with four layers in 2 stages of TP 2 on the
four ranks, 4 microbatches streamed through ``pipeline_forward``, the
ring's activations copied through the host; every rank's logits held to
the single device's) and serve_verified (the serving launcher's
``--verify-tp`` pre-flight, then serving on the card).  Then a ``kernels`` line and, last, ``{"ok": true,
"device": {...}}``.  Any failure raises, so the exit code is not 0; without
a CUDA device the script exits 1 before any phase.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import json
import math
import os
import platform
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
sys.path.append(str(Path(__file__).resolve().parent / "tests"))
from card_cases import (CONV_CASES, DISPATCH_CASES, FA_CASES, FA_TOL, RN_CASES,  # noqa: E402
                        RN_TOL, SGN_CASES, SGN_EPS, SGN_TOL, SSD_CASES, SSD_TOL, close,
                        conv_inputs, fa_inputs, mamba2_dt_A, randn, recorded_dispatch, rn_inputs,
                        sgn_check, sgn_inputs, ssd_inputs)
from repro_torch.configs import ShapeSpec, get_config, input_specs  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeDtype  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import causal_conv as cc  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_dispatch as md  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import skip_gated_norm as sgn  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch import analysis  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.dryrun import _zero_flags_from_specs  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import mlp, ssm  # noqa: E402
from repro_torch.parallel import spmd  # noqa: E402
from repro_torch.parallel.ctx import ParallelCtx  # noqa: E402
from repro_torch.parallel.sharding import cache_specs, param_specs, shard_params  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train.trainer import (TrainConfig, local_grads, make_step_fn,  # noqa: E402
                                      step_phases)
from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map  # noqa: E402
from repro_torch.verify import Plan, Session, run_campaign  # noqa: E402

SEED = 0
# Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA data
# sheet), the H100 hardware model of repro_torch.launch.analysis.
PEAK_FLOPS = {torch.bfloat16: analysis.PEAK_FLOPS, torch.float32: analysis.PEAK_FLOPS_F32}
PEAK_BYTES = analysis.HBM_BW
L2_BYTES = 50 * 2**20  # H100 SXM
# Model logits (RMS about 1) from two bf16 paths that round attention's p at
# different tile boundaries in each of 36 layers.  A CPU emulation (key
# chunks of 64 against 1024, S=512, 36 layers at full width) differed by
# 1.8% relative RMS and 0.11 at most; the bounds leave about 3x headroom.
# They hold hubert_xlarge's prefill too: the same emulation
# (scripts/frontend_logit_bounds.py, full width and depth, frames (2, 1024),
# on the H100 machine's host) read 1.36% and 0.070.
LOGIT_REL_RMS = 5e-2
LOGIT_MAX_ABS = 0.5
# internvl2_26b's logits (RMS about 1), prefill against the reference path
# and against decode_step, (relative RMS error, max abs error): the same
# emulation at full depth, patches (2, 256) and tokens (2, 768), in bf16 on
# the card (scripts/frontend_logit_bounds.py --device cuda: both plain paths,
# no kernel) read 2.77% and 0.164; the bounds leave about 3x headroom.
VLM_LOGIT_BOUNDS = (8e-2, 0.5)
# mamba2_130m logits (RMS about 1), (relative RMS error, max abs error).  The
# SSD layers are f32 inside, but a bf16 rounding of their output that moves
# with f32 summation order grows through the next 23 layers.  A CPU emulation
# (scripts/ssm_logit_bounds.py: full width and depth, batch (1, 512) and a
# 256-token prefill against decode_step) differed by 2.1% and 3.2% relative
# RMS and 0.38 at most (2.6e-6 relative in f32); the bounds leave about 3x
# headroom, more on the max over the 32x larger chip batch.
SSM_LOGIT_BOUNDS = (0.1, 1.5)
# llama3_8b TP-4 logits (RMS about 1) against the single-device model, both
# through the kernels, (relative RMS error, max abs error).  TP changes only
# the order of the row-parallel sums (four bf16 partial sums added by the
# all_reduce) and the vocab-parallel embedding (exact).  A CPU emulation of
# the same comparison (scripts/tp_logit_bounds.py: full width, 2 layers,
# tokens (1, 1024), bf16, reference path, run on the H100 machine's host)
# read 1.09% relative RMS and 0.066 at most (1.7e-6 in f32); the bounds
# leave about 3x headroom.
TP_LOGIT_BOUNDS = (3e-2, 0.2)
TP_SIZE, TP_LAYERS, TP_TOKENS = 4, 2, (1, 1024)
# The tp x dp program (the verifier's tpdp-forward): llama3_8b, TP_LAYERS
# layers, TPDP_TP x (4 / TPDP_TP) on four gloo ranks, tokens TPDP_TOKENS
# split by rows over the data axis; each rank's (rows, vocab shard) block
# of the logits held to the single device's at TP_LOGIT_BOUNDS (the model
# axis changes the order of the row-parallel sums, the data axis only how
# many rows each product takes).
TPDP_TP, TPDP_TOKENS = 2, (2, 1024)
# The pipeline x TP program: llama3_8b, PIPE_LAYERS layers in PIPE_STAGES
# stages of TP (4 / PIPE_STAGES) on four gloo ranks, PIPE_MICRO microbatches
# of one sequence of PIPE_SEQ tokens; every rank's vocab shard of the
# logits held to the single device's at TP_LOGIT_BOUNDS (the ring moves
# activations unchanged; TP changes the order of the row-parallel sums).
PIPE_STAGES, PIPE_LAYERS, PIPE_MICRO, PIPE_SEQ = 2, 4, 4, 1024
# The context-parallel decode step: llama3_8b, TP_LAYERS layers, bf16, on
# four gloo ranks as a (data, model) = (CP_SIZE, CP_TP) mesh whose data axis
# cuts the KV cache along the sequence (CP_MAX_LEN / CP_SIZE positions a
# rank).  The single-device caches are filled by the prefill of a
# CP_PROMPT prompt, then CP_STEPS tokens are decoded from position
# CP_PROMPT[1], so the write moves from the first sequence shard to the
# second mid-run; every step's vocab shard of the logits is held to the
# single-device decode_step at TP_LOGIT_BOUNDS (the flash-decode merge sums
# the shards' partial softmax in another order, and TP the row-parallel
# sums).
CP_TP, CP_SIZE = 2, 2
CP_MAX_LEN, CP_PROMPT, CP_STEPS = 8192, (2, 4090), 12
# dp-grad, the DP gradient-sync contract.  The verify part proves
# Plan.grad(dp=DP_SIZE) for DP_GRAD_VERIFY at full width, DP_GRAD_VERIFY_LAYERS
# layers, seq 8 (the JAX package's own case is 2 layers), on the card's
# host.  At full depth both verify there too, in 27.8 s (llama3_8b) and
# 40.0 s (qwen3_4b) on an H100 machine's host, but the whole run then took
# 797 s, past the 12 minutes it is held to, so the depth is cut.  The run
# part runs spmd.dp_grad, the program proved, on DP_SIZE gloo ranks:
# llama3_8b at full width with DP_GRAD_LAYERS layers, f32, TF32 off, tokens
# DP_GRAD_TOKENS, one row a rank; each rank's psummed gradient is held to
# the single device's full-batch gradient, leaf by leaf (max abs error over
# the leaf's max abs value), within DP_GRAD_REL: about 3x the first card
# run's reading (H100 80GB HBM3, 700 W), 1.29e-5 at worst (ln_f's scale;
# the others 1.1e-6 to 7.8e-6), the psum adding the two rows' gradients in
# another order than one device's products over both rows.
DP_GRAD_VERIFY, DP_GRAD_VERIFY_LAYERS = ("llama3_8b", "qwen3_4b"), 8
DP_GRAD_LAYERS, DP_GRAD_TOKENS = 2, (2, 256)
DP_GRAD_REL = 4e-5
# The JAX reference's outcome of every cell of ``python -m repro.verify
# campaign --arch <arch> --tp 4 --scenarios <scenario>`` (written here as
# data: this script imports nothing of the JAX package), by (arch,
# scenario), listing the injectors that find no site ("skipped") and the
# rest detected.  tp-forward and tp-decode have no all_gather or
# reduce_scatter; sp-forward has no all_reduce; mamba2_130m's SSM layers
# have no transpose whose two leading dims both move data.
_INJECTORS = ("drop_all_reduce", "duplicate_all_reduce", "precision_drop",
              "shifted_slice", "swap_reshape_dims", "wrong_all_gather_dim",
              "wrong_collective_axis", "wrong_collective_op", "wrong_replica_groups",
              "wrong_scatter_dim", "wrong_transpose")


def _reference(*skipped: str, mislocalized: tuple = ()) -> dict:
    return {"": "clean_pass", **{i: "skipped" if i in skipped else
                                 "mislocalized" if i in mislocalized else "detected"
                                 for i in _INJECTORS}}


CAMPAIGN_REFERENCE = {
    ("llama3_8b", "tp-forward"): _reference("wrong_all_gather_dim", "wrong_scatter_dim"),
    ("llama3_8b", "tp-decode"): _reference("wrong_all_gather_dim", "wrong_scatter_dim"),
    ("llama3_8b", "sp-forward"): _reference(
        "drop_all_reduce", "duplicate_all_reduce", "wrong_collective_axis",
        "wrong_collective_op", "wrong_replica_groups"),
    ("mamba2_130m", "tp-forward"): _reference(
        "wrong_all_gather_dim", "wrong_scatter_dim", "wrong_transpose"),
    ("gemma_2b", "tp-forward"): _reference("wrong_all_gather_dim", "wrong_scatter_dim"),
    # dp-forward (dp 2) has no collective: only the injectors that rewrite
    # local ops find a site
    ("gemma_2b", "dp-forward"): _reference(
        "drop_all_reduce", "duplicate_all_reduce", "wrong_all_gather_dim",
        "wrong_collective_axis", "wrong_collective_op", "wrong_replica_groups",
        "wrong_scatter_dim"),
    ("hubert_xlarge", "tp-forward"): _reference("wrong_all_gather_dim", "wrong_scatter_dim"),
    # the frontend prefix enters the SP region by a slice, after the token
    # embedding's all_reduce; a fault planted in that all_reduce is detected
    # but its site is not among the top-ranked ones, in both packages
    ("internvl2_26b", "sp-forward"): _reference(mislocalized=(
        "drop_all_reduce", "duplicate_all_reduce", "wrong_collective_axis",
        "wrong_replica_groups")),
    # the MoE archs: the experts' all_reduce beside the attention's, so
    # sp-forward has all_reduces too; a dropped all_reduce in sp-forward and
    # in ep-moe-forward is detected but not localized, in both packages
    **{(arch, kind): _reference(
        *(() if kind == "sp-forward" else ("wrong_all_gather_dim", "wrong_scatter_dim")),
        mislocalized=("drop_all_reduce",) if kind in ("sp-forward", "ep-moe-forward")
        else ())
       for arch in ("granite_moe_3b", "mixtral_8x7b")
       for kind in ("tp-forward", "tp-decode", "sp-forward", "ep-moe-forward")},
}
# The injected cells of each CAMPAIGN_REFERENCE pair that the JAX reference's
# lint tier flags baseline-free (``lint_detected``), by (arch, scenario), as
# ``JAX_PLATFORMS=cpu PYTHONPATH=src python tests/campaign_lint_reference.py``
# prints them from the reference's campaign on the CPU (written here as
# data; the port's cells gave the same there).  sp-forward has no
# all_reduce of its own to drop; the frontend prefix's and the experts'
# all_reduces sit where only some rewrites break the sharding lints.
_AR_LINT = ("drop_all_reduce", "duplicate_all_reduce", "wrong_collective_axis",
            "wrong_collective_op", "wrong_replica_groups")
CAMPAIGN_LINT = {
    ("llama3_8b", "tp-forward"): _AR_LINT, ("llama3_8b", "tp-decode"): _AR_LINT,
    ("llama3_8b", "sp-forward"): ("wrong_all_gather_dim",),
    ("mamba2_130m", "tp-forward"): _AR_LINT, ("gemma_2b", "tp-forward"): _AR_LINT,
    ("gemma_2b", "dp-forward"): (), ("hubert_xlarge", "tp-forward"): _AR_LINT,
    ("internvl2_26b", "sp-forward"): ("duplicate_all_reduce", "wrong_collective_axis"),
    **{(arch, kind): flagged
       for arch in ("granite_moe_3b", "mixtral_8x7b")
       for kind, flagged in (
           ("tp-forward", _AR_LINT), ("tp-decode", _AR_LINT),
           ("sp-forward", ("duplicate_all_reduce", "wrong_all_gather_dim",
                           "wrong_collective_axis", "wrong_collective_op",
                           "wrong_replica_groups")),
           ("ep-moe-forward", ("duplicate_all_reduce", "wrong_collective_axis")))},
}
DP_SIZE = 2
# The plans the verify phase proves at full width and depth, (arch, scenario,
# axis size), each with the memo hits of ``python -m repro.verify <arch>
# --tp N [--decode | --sp]`` (``--dp 2``), the JAX reference, on the CPU
# (written here as data).  llama3_70b and llama3_405b at tp 16 are the
# paper's Table 2 L2 and L3 rows.
VERIFY_PLANS = {
    ("llama3_8b", "tp-forward", TP_SIZE): 30, ("qwen3_4b", "tp-forward", TP_SIZE): 34,
    ("mamba2_130m", "tp-forward", TP_SIZE): 22, ("qwen1_5_4b", "tp-forward", TP_SIZE): 38,
    ("chatglm3_6b", "tp-forward", TP_SIZE): 26, ("gemma_2b", "tp-forward", TP_SIZE): 16,
    ("llama3_8b", "tp-decode", TP_SIZE): 61, ("qwen3_4b", "tp-decode", TP_SIZE): 69,
    ("mamba2_130m", "tp-decode", TP_SIZE): 45, ("qwen1_5_4b", "tp-decode", TP_SIZE): 77,
    ("chatglm3_6b", "tp-decode", TP_SIZE): 53, ("gemma_2b", "tp-decode", TP_SIZE): 33,
    ("llama3_8b", "sp-forward", TP_SIZE): 30, ("gemma_2b", "sp-forward", TP_SIZE): 16,
    ("llama3_70b", "tp-forward", 16): 78, ("llama3_405b", "tp-forward", 16): 124,
    ("gemma_2b", "dp-forward", DP_SIZE): 16, ("llama3_8b", "dp-forward", DP_SIZE): 30,
    ("hubert_xlarge", "tp-forward", TP_SIZE): 46, ("hubert_xlarge", "sp-forward", TP_SIZE): 46,
    ("internvl2_26b", "tp-forward", TP_SIZE): 46, ("internvl2_26b", "tp-decode", TP_SIZE): 93,
    ("internvl2_26b", "sp-forward", TP_SIZE): 46,
    # the MoE archs; mixtral_8x7b at tp 16 and mixtral_8x22b at tp 16 are
    # Table 2's M1 and M2 rows, mixtral_8x7b at ep 4 its E1 row
    ("granite_moe_3b", "tp-forward", TP_SIZE): 30,
    ("granite_moe_3b", "ep-moe-forward", TP_SIZE): 30,
    ("granite_moe_3b", "tp-decode", TP_SIZE): 61,
    ("granite_moe_3b", "sp-forward", TP_SIZE): 30,
    ("moonshot_v1_16b", "tp-forward", TP_SIZE): 46,
    ("moonshot_v1_16b", "ep-moe-forward", TP_SIZE): 46,
    ("mixtral_8x7b", "tp-forward", TP_SIZE): 30,
    ("mixtral_8x7b", "ep-moe-forward", TP_SIZE): 30,
    ("mixtral_8x7b", "tp-forward", 16): 30, ("mixtral_8x22b", "tp-forward", 16): 54,
    ("jamba_1_5_large", "tp-forward", TP_SIZE): 66,
}
# Plans of more than one scenario, by (arch, the CLI's flags): the Plan's
# keywords and the memo hits of ``python -m repro.verify <arch> <flags>``
# summed over the plan's scenarios, the JAX reference, on the CPU (written
# here as data).  A pipeline plan verifies each stage (TP inside it); the
# composite verifies tp-forward, then the tp x dp program against the TP
# program (tpdp-forward).  llama3_405b in two stages is Table 2's L3 row
# under a pipeline layout.
VERIFY_MULTI = {
    ("llama3_8b", "--pipeline 4 --tp 4"): (dict(mode="pipeline", stages=4, tp=4), 24),
    ("llama3_8b", "--tp 4 --dp 2 --composite"): (dict(tp=4, dp=2, composite=True), 60),
    ("llama3_405b", "--pipeline 2 --tp 16"): (dict(mode="pipeline", stages=2, tp=16), 122),
    ("granite_moe_3b", "--pipeline 2 --tp 4"): (dict(mode="pipeline", stages=2, tp=4), 28),
}
# llama3_8b TP-4 serving step (TP_LAYERS layers, batch 2) against the
# single-device decode_step: a TP_DECODE_PROMPT-token prompt fed one
# position at a time, then TP_DECODE_STEPS more, into caches of
# TP_DECODE_MAX_LEN positions.  (Every step's logits: relative RMS error,
# max abs error; the final cache shards: relative RMS error of the worst
# leaf.)  A CPU emulation of the same comparison (scripts/tp_logit_bounds.py
# --decode: full width, 2 layers, batch 2, 32 + 8 positions, bf16, reference
# path, run on the H100 machine's host) read 1.03% relative RMS over all
# steps (1.09% at the worst step), 0.056 at most, and 0.58% on the worst
# cache leaf (1.4e-6 and 9e-7 in f32); the bounds leave about 3x headroom.
TP_DECODE_BATCH, TP_DECODE_PROMPT, TP_DECODE_STEPS, TP_DECODE_MAX_LEN = 2, 32, 8, 64
TP_DECODE_BOUNDS = (3e-2, 0.2)
TP_DECODE_CACHE_REL_RMS = 2e-2
# gemma_2b on DP_SIZE ranks, tokens DP_TOKENS split by rows, against the
# single-device forward of the whole batch, both through the kernels,
# (relative RMS error, max abs error).  DP changes only how many rows each
# matrix product takes.  A CPU emulation of the same comparison
# (scripts/tp_logit_bounds.py --dp 2: full width and depth, tokens (2,
# 1024), run on the H100 machine's host) read 0.0 in bf16 and f32: the rows
# come out bit for bit.  On the card a matrix library may pick another
# schedule for 1024 rows than for 2048, which reorders the f32 sums inside
# a product, a smaller change than TP's bf16 partial sums; TP's bounds hold
# it.  A rank that computes another rank's rows reads about 1.4.
DP_TOKENS = (2, 1024)
DP_LOGIT_BOUNDS = TP_LOGIT_BOUNDS
# Training.  train: qwen3_4b at full width and depth, bf16, on the trainer's
# path (impl="reference": the kernels have no backward), TRAIN_STEPS steps
# of (batch, seq) TRAIN_BATCH from SyntheticLM.  Its first step's loss is
# held to the loss the kernel path's logits give for the same weights and
# batch, within TRAIN_LOSS_BOUND (absolute, in nats): 3x the largest
# reading of scripts/train_loss_bounds.py on an H100 (0.0012 over seeds
# 0-2, losses about 12.4; PERF.md section 6).
TRAIN_BATCH, TRAIN_STEPS = (4, 256), 8
TRAIN_LOSS_BOUND = 3.6e-3
TRAIN_OPT = AdamWConfig(lr=1e-3, warmup_steps=2)
# train_parity: one f32 step of qwen3_4b cut to PARITY_LAYERS layers on the
# card and on its host, from the same weights, batch and state, TF32 off;
# each quantity's worst relative error (a leaf's max abs error over its max
# abs value) within 3x the first card run's reading, a reading under one f32
# ulp (2^-23) taken as one ulp.  That run (H100 80GB HBM3, 700 W) read loss
# 7.6e-8, grad_norm 0, m 3.9e-6, v 4.2e-6, params 6.2e-4: one step moves a
# parameter by about lr * m / sqrt(v), whose sign flips where a gradient
# sits near zero and the two devices' sums round it apart.
PARITY_LAYERS, PARITY_BATCH = 2, (2, 64)
PARITY_BOUNDS = {"loss": 3.6e-7, "grad_norm": 3.6e-7, "params": 1.9e-3, "m": 1.2e-5,
                 "v": 1.3e-5}
# tpdp_train: one f32 step of qwen3_4b cut to PARITY_LAYERS layers on four
# gloo ranks sharing the card, a (data, model) = (2, TPDP_TP) mesh, global
# batch TPDP_TRAIN_BATCH, against the single-device step on the card, plain
# and ZeRO-1, at the JAX reference's own bounds
# (tests/test_tp_equivalence.py:131-142): loss relative error and the worst
# parameter's absolute delta.  Those bounds pass a rank whose loss drops the
# label logit's psum (a 3.4e-4 relative change at random weights, where the
# label logits are small beside the log-sum-exp, and AdamW's first step
# hides the gradient's scale), so each rank's loss is also held to the
# single device's within TPDP_TRAIN_LOSS_REL: 3x one f32 ulp, the first card
# runs on an H100 having read the same loss bit for bit.
# A first AdamW step moves every parameter by about lr whatever its
# gradient, so the parameter bound cannot see the data-axis reduction, its
# ``/ dp``, the ZeRO-1 scatter or the clip.  Each rank's moments and
# gradient norm are therefore also held, within TPDP_TRAIN_MOMENT_REL (the
# worst leaf's max abs error over its max abs value; the norm's relative
# error), to a plain first step computed on the rank from every data rank's
# local gradients, gathered by torch.distributed's own all_gather: their
# mean, its norm, the clip, and m = (1 - b1) g, v = (1 - b2) g^2 (ZeRO-1:
# the rank's slice).  The two differ only in the order in which the norm's
# squares are summed, a few f32 ulps (2^-23 each).  The "sp" variant is the
# plain step with sequence parallelism (the model axis' psums become a
# reduce_scatter and an all_gather, through the host on the card); each
# rank's loss is also held to the TP step's within TPDP_TRAIN_LOSS_REL, and
# its first-step m, v and gradient norm to the TP step's within
# TPDP_TRAIN_MOMENT_REL (the TP step's own moments being held to the plain
# first step, the SP step's are not gathered again).
TPDP_TRAIN_BATCH = (4, 256)
TPDP_TRAIN_BOUNDS = (0.02, 2e-2)
TPDP_TRAIN_LOSS_REL = 3.6e-7
TPDP_TRAIN_MOMENT_REL = 1e-5
TPDP_TRAIN_OPT = AdamWConfig(lr=1e-3, warmup_steps=1)
# variant -> (train config, sequence parallelism); the SP step runs right
# after the plain one, whose loss, moments and norm it is held to
TPDP_TRAIN_VARIANTS = {"plain": (TrainConfig(opt=TPDP_TRAIN_OPT, remat=False), False),
                       "sp": (TrainConfig(opt=TPDP_TRAIN_OPT, remat=False), True),
                       "zero1": (TrainConfig(opt=TPDP_TRAIN_OPT, remat=False, zero1=True),
                                 False)}
# MoE logits (RMS about 1) against another run of the same model, as three
# limits: (relative RMS error, max abs error) over every token ("all"); the
# same over the tokens that both runs route alike, with equal top-k expert
# sets in every MoE layer ("stable"); and the share of (token, MoE layer)
# pairs whose top-k sets differ ("flip_share").  Both runs take the same
# capacity dispatch.  The prefill's runs differ in attention's rounding
# (kernel against reference path), the TP run's in the order of its
# row-parallel sums.  In bf16 a rounding that moves a token's router
# probabilities across a near-tie sends it to other experts (and may push
# its pairs past capacity): that token moves by a whole expert output, and
# through attention the tokens after it.  scripts/moe_logit_bounds.py
# emulates each comparison with plain paths on the card (the prefill: key
# chunks of 64 against 1024; TP: four gloo ranks, rank 0's routing against
# the single device's) and read (PERF.md, PR 18 call 2; f32: no flip,
# 1e-6): granite_moe_3b 2.90% and 0.352 over all tokens, 1.52% and 0.156
# over the 172 of 2048 tokens routed alike in all 32 layers, 12.8% of
# token-layers flipped; mixtral_8x7b (8 layers) 12.2% and 3.18, 3.66% and
# 1.19, 4.1%; granite's TP-4 program (4 layers) 3.58% and 1.49, 1.79% and
# 0.572, 10.0%.  moonshot_v1_16b (48 layers, 64 experts of width 1408, top
# 6, a shared expert of width 2816; bf16 only: an f32 copy does not fit on
# the card), the largest of three seeds' readings (seeds 0-2, PERF.md):
# 9.88% and 2.61, 1.86% and 0.211 over the 7-12 tokens routed alike, 31.7%
# of token-layers flipped.  Each limit is about 3x its reading.
MOE_BOUNDS = {
    "granite_moe_3b": {"all": (9e-2, 1.1), "stable": (4.5e-2, 0.5), "flip_share": 0.4},
    "mixtral_8x7b": {"all": (0.37, 9.5), "stable": (0.11, 3.6), "flip_share": 0.13},
    "tp": {"all": (0.11, 4.5), "stable": (5.5e-2, 1.7), "flip_share": 0.3},
    "moonshot_v1_16b": {"all": (0.3, 7.8), "stable": (5.6e-2, 0.65), "flip_share": 0.95},
}
MIXTRAL_LAYERS = 8
# The capacity dispatch of one MoE layer against a plain per-expert loop
# (the first C pairs routed to each expert, in token order, each token the
# weighted sum of its kept pairs' expert outputs, in f32), on the card, at
# the prefill's token count: (allclose rtol = atol, relative RMS error).
# The dispatch rounds each expert's output and the weighted sum in bf16,
# the loop in f32; a pair dropped or kept wrongly moves its token by a
# whole expert output.
MOE_DISPATCH_TOL = (5e-2, 2e-2)
# granite_moe_3b's execution program on TP_SIZE gloo ranks (experts split
# over the ranks, each running the capacity dispatch for its own) against
# the single device, MOE_TP_LAYERS layers, tokens TP_TOKENS, held to
# MOE_BOUNDS["tp"].
MOE_TP_LAYERS = 4

def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def rotations(args: tuple) -> list[tuple]:
    """``args`` and enough copies of it that cycling through them moves four
    L2s of inputs between two uses of one copy: every timed call then reads
    its inputs from HBM, as ``bound_ms`` assumes."""
    n = 1 + -(-4 * L2_BYTES // nbytes(*args))
    return [args] + [tuple(t.clone() for t in args) for _ in range(n - 1)]


def call_ms(fn, args: tuple, iters: int = 20, warmup: int = 3) -> float:
    """Eager time of one call, host launch overhead included: CUDA events
    around ``iters`` back-to-back calls on rotating input copies."""
    copies = rotations(args)
    for i in range(warmup):
        fn(*copies[i % len(copies)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*copies[i % len(copies)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, args: tuple, iters: int = 20, reps: int = 5) -> float:
    """Device time of one call: ``iters`` calls on rotating input copies
    (see ``rotations``) captured in one CUDA graph, replayed ``reps`` times
    between CUDA events, so the host's launch overhead is left out."""
    copies = rotations(args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(*copies[i % len(copies)])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*copies[i % len(copies)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def bound(nbytes: float, *work: tuple[float, torch.dtype]) -> tuple[float, str]:
    """Least time, in ms, for moving ``nbytes`` and doing each ``(flops, type)``
    of ``work`` at the card's peak for that type (the types' times add up)."""
    t_ops = sum(flops / PEAK_FLOPS[dtype] for flops, dtype in work)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def draw_batch(cfg, gen, batch: int, seq: int) -> dict:
    """A (batch, seq) prefill's inputs, named, shaped and typed as
    ``input_specs`` gives them, on the generator's device: float frames or
    patches drawn N(0, 1), tokens uniform over the vocabulary."""
    out = {}
    for name, spec in input_specs(cfg, ShapeSpec("prefill", seq, batch, "prefill")).items():
        if spec.dtype.is_floating_point:
            out[name] = torch.randn(spec.shape, generator=gen, device=gen.device).to(spec.dtype)
        else:
            out[name] = torch.randint(0, cfg.vocab, spec.shape, generator=gen, device=gen.device,
                                      dtype=spec.dtype)
    return out


def logit_check(name: str, out, ref, bounds=(LOGIT_REL_RMS, LOGIT_MAX_ABS)) -> dict:
    out, ref = out.float(), ref.float()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f"{name}: shape {tuple(out.shape)} or non-finite logits")
    diff = out - ref
    rel = (diff.norm() / ref.norm()).item()
    mx = diff.abs().max().item()
    if rel > bounds[0] or mx > bounds[1]:
        raise AssertionError(f"{name}: rel rms err {rel}, max abs err {mx}")
    return {"rel_rms_err": rel, "max_abs_err": mx, "tol_rel_rms": bounds[0],
            "tol_max_abs": bounds[1]}


def flipped_tokens(got: list, ref: list):
    """(T,) bool: the tokens whose top-k expert sets differ between two
    runs' routings (lists of (T, K) ids, one per MoE layer) in some layer."""
    out = torch.zeros(got[0].shape[0], dtype=torch.bool, device=got[0].device)
    for a, b in zip(got, ref):
        out |= (a.sort(-1).values != b.to(a.device).sort(-1).values).any(-1)
    return out


def moe_logit_check(name: str, out, ref, got: list, want: list, bounds: dict) -> dict:
    """``logit_check`` of a MoE model's logits (B, S, V) under the three
    limits of ``MOE_BOUNDS`` (see there); ``got`` and ``want`` are the two
    runs' routings."""
    flipped = flipped_tokens(got, want)
    V = out.shape[-1]
    stable = ~flipped.to(out.device)
    check = logit_check(name, out, ref, bounds["all"])
    check["stable_tokens"] = logit_check(
        f"{name}, tokens routed alike", out.reshape(-1, V)[stable],
        ref.to(out.device).reshape(-1, V)[stable], bounds["stable"])
    flips = sum(int(topk_flips(a, b.to(a.device))) for a, b in zip(got, want))
    share = flips / (len(got) * got[0].shape[0])
    check.update(flipped_tokens=int(flipped.sum()), topk_set_flips=flips,
                 flip_share=share, tol_flip_share=bounds["flip_share"])
    if share > bounds["flip_share"]:
        raise AssertionError(f"{name}: {share} of the token-layers routed differently")
    return check


def init_mamba2(model, gen: torch.Generator) -> dict:
    """``model.init`` with every SSM block's ``dt_bias`` and ``A_log``
    redrawn by ``mamba2_dt_A``: at the JAX package's init (dt_bias 0, A_log
    N(0, 1)) the median head decays its state by about exp(-0.69 * 128)
    over a chunk, so the carry between chunks would not show."""
    params = model.init(gen)
    for blk in params["blocks"]:
        if "ssm" in blk:
            dt_bias, A_log = mamba2_dt_A(gen, blk["ssm"]["dt_bias"].shape)
            blk["ssm"]["dt_bias"].copy_(dt_bias)
            blk["ssm"]["A_log"].copy_(A_log)
    return params


def counts() -> dict:
    return {"flash_attention": fa.flash_attention.launches,
            "rmsnorm": rn.rmsnorm.launches, "ssd_scan": ssd.ssd_scan.launches,
            "causal_conv": cc.causal_conv.launches,
            "moe_gather": md.moe_gather.launches, "moe_combine": md.moe_combine.launches,
            "skip_gated_norm": sgn.skip_gated_norm.launches}


def reset_counts() -> None:
    fa.flash_attention.launches = rn.rmsnorm.launches = ssd.ssd_scan.launches = 0
    cc.causal_conv.launches = md.moe_gather.launches = md.moe_combine.launches = 0
    sgn.skip_gated_norm.launches = 0


def want_counts(flash: int = 0, ssd_scans: int = 0, moe: int = 0) -> dict:
    """``counts()`` as a forward of ``flash`` attention layers, ``ssd_scans``
    SSD layers (a scan, a fused conv and a skip and gated norm each) and
    ``moe`` MoE layers on the kernel path launches them."""
    return {"flash_attention": flash, "rmsnorm": 0, "ssd_scan": ssd_scans,
            "causal_conv": ssd_scans, "moe_gather": moe, "moe_combine": moe,
            "skip_gated_norm": ssd_scans}


def moe_layers(cfg, layers: int) -> int:
    return sum(cfg.is_moe_layer(i) for i in range(layers))


def phase_device() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    # every f32 product compared here runs in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    libs = build.build_all()  # one nvcc per source, all started together
    t1 = time.perf_counter()
    x = torch.ones((4, 128), dtype=torch.bfloat16, device="cuda")
    rn.rmsnorm(x, x[0].contiguous())  # compiles the Triton kernel
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    build_s = {f"{name}_nvcc": build.BUILD_SECONDS.get(name)  # None: reused, not built
               for name in sorted(libs)}
    info = {"name": torch.cuda.get_device_name(0),
            "capability": list(torch.cuda.get_device_capability(0)),
            "nvidia_smi": smi.splitlines()[0], "torch": torch.__version__,
            "cuda": torch.version.cuda, "libraries": sorted(libs),
            "build_s": {**build_s, "all_nvcc_wall": t1 - t0, "rmsnorm_triton": t2 - t1}}
    emit("device", **info)


def _kernel_name(mangled: str) -> str:
    """``flash_fwd_bf16<128>`` from the mangled name of a kernel in an
    anonymous namespace."""
    i, name = mangled.index("N") + 1, ""
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    m = re.match(r"ILi(\d+)E", mangled[i:])
    return name + (f"<{m[1]}>" if m else "")


def ptxas_report(log: str, smem: dict) -> list:
    """Each kernel of an ``nvcc -Xptxas -v`` log: its registers, stack and
    spills, the codes of the notes and warnings ptxas gave it (C7512 or
    C7520: wgmmas serialised; C7508: setmaxnreg ignored), and from ``smem``
    (name -> bytes) the dynamic shared memory a block asks for."""
    funcs, cur, notes = [], None, {}
    for line in log.splitlines():
        if m := re.search(r"\((C\d{4})\).*'(\w+)'", line):
            notes.setdefault(_kernel_name(m[2]), []).append(m[1])
        elif m := re.search(r"Compiling entry function '(\w+)'", line):
            cur = {"function": _kernel_name(m[1])}
            cur["dynamic_smem_bytes"] = smem.get(cur["function"])
            funcs.append(cur)
        elif cur is not None:
            if m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line):
                cur.update(stack_bytes=int(m[1]), spill_store_bytes=int(m[2]))
            if m := re.search(r"Used (\d+) registers", line):
                cur["registers"] = int(m[1])
            if m := re.search(r"(\d+) bytes smem", line):
                cur["static_smem_bytes"] = int(m[1])
    for f in funcs:
        f["ptxas_notes"] = notes.get(f["function"], [])
    return funcs


def phase_resources() -> None:
    """``ptxas_report`` of every kernel library."""
    fa_smem = build.bind("flash_attention", "repro_flash_attention_smem_bytes", ctypes.c_int,
                         (ctypes.c_int,) * 2)
    ssd_smem = build.bind("ssd_scan", "repro_ssd_scan_smem_bytes", ctypes.c_int,
                          (ctypes.c_int,) * 3)
    smem = {}
    for D in fa.HEAD_DIMS:
        smem[f"flash_fwd_bf16<{D}>"] = fa_smem(1, D)
        smem[f"flash_fwd_f32<{D}>"] = fa_smem(0, D)
    for P in (16, 32, 64):
        smem[f"ssd_scan_f32<{P}>"] = ssd_smem(0, P, 128)
    for P in (16, 32):
        smem[f"ssd_scan_bf16<{P}>"] = ssd_smem(1, P, 128)
    smem["ssd_chunk_products"] = ssd_smem(2, 0, 128)
    out = {src.stem: ptxas_report(build.target(src).with_suffix(".log").read_text(), smem)
           for src in build.sources()}
    emit("kernel resources", **out)


def timed_row(fn, plain, args: tuple, tol, library, moved: float, *work) -> dict:
    """One main path's row: ``fn`` held to ``plain`` on ``args`` within
    ``tol`` (``card_cases.close``; None: bit for bit), over each output, its
    device and call times beside ``plain``'s (and ``library``'s, where one
    PyTorch call computes the same), and the bound of moving ``moved`` bytes
    and doing ``work`` (see ``bound``)."""
    got, want = fn(*args), plain(*args)
    if torch.is_tensor(got):
        got, want = (got,), (want,)
    row = {"tol": tol or "bit for bit",
           "max_abs_err": max(close(g, w, tol) for g, w in zip(got, want))}
    del got, want
    row.update(ms=time_ms(fn, args), call_ms=call_ms(fn, args),
               plain_ms=time_ms(plain, args, iters=4),
               library_ms=None if library is None else time_ms(library, args))
    row["bound_ms"], row["bound_by"] = bound(moved, *work)
    return row


def phase_flash(gen) -> dict:
    """``timed_row`` of each FA_CASES row of a main path, at the path's
    softmax scale, beside SDPA; returned by path."""
    rows = {}
    for c in (c for c in FA_CASES if c.path):
        q, k, v = fa_inputs(gen, c)
        pairs = sum(min(r + 1, c.Sk) for r in range(c.Sq)) if c.causal else c.Sq * c.Sk
        row = rows[c.path] = {"shape": [c.B, c.Hq, c.Hkv, c.Sq, c.Sk, c.D], **timed_row(
            lambda *a: fa.flash_attention(*a, causal=c.causal, scale=c.scale),
            lambda *a: fa.flash_attention_plain(*a, causal=c.causal, scale=c.scale),
            (q, k, v), FA_TOL[c.dtype],
            lambda *a: F.scaled_dot_product_attention(*a, is_causal=c.causal, enable_gqa=True,
                                                      scale=c.scale),
            nbytes(q, k, v, q), (4.0 * c.D * c.B * c.Hq * pairs, c.dtype))}
        emit("kernel flash_attention", dtype=str(c.dtype), causal=c.causal, scale=c.scale,
             path=c.path, **row)
    return rows


def phase_rmsnorm(gen) -> dict:
    """``timed_row`` of each RN_CASES row of a main path, beside
    ``F.rms_norm``; returned by path."""
    rows = {}
    for c in (c for c in RN_CASES if c.path):
        x, s = rn_inputs(gen, c)
        row = rows[c.path] = timed_row(
            rn.rmsnorm, rn.rmsnorm_plain, (x, s), RN_TOL[c.dtype], lambda a, b: F.rms_norm(a, (c.D,), b, 1e-5),
            nbytes(x, s, x), (4.0 * x.numel(), c.dtype))
        emit("kernel rmsnorm", shape=[c.rows, c.D], dtype=str(c.dtype), path=c.path, **row)
    return rows


def phase_ssd(gen) -> dict:
    """``timed_row`` of each SSD_CASES row of a main path; returned by path."""
    rows = {}
    for c in (c for c in SSD_CASES if c.path):
        args = ssd_inputs(gen, c)
        q = ssd.chunk_len(c.S, c.chunk)
        # The work the scan needs: C B^T on the causal pairs once per
        # (b, chunk), since all heads share one B and C, in the type of
        # B and C (bf16 x bf16 products are exact in f32); per (b, h,
        # chunk), M x on the causal pairs, C state and the state update.
        # For bf16 inputs the kernel runs each per-head product as two
        # bf16 tensor-core passes (an f32 operand split into hi + lo
        # against an exact bf16 one), so they count twice at the bf16
        # peak; f32 inputs run them as f32 FMA.
        cbt = c.B * (c.S // q) * q * (q + 1) * c.N
        per_head = c.B * c.H * (c.S // q) * (q * (q + 1) * c.P + 4 * q * c.N * c.P)
        per_head_work = ((2 * per_head, torch.bfloat16) if c.dtype == torch.bfloat16
                         else (per_head, torch.float32))
        moved = nbytes(*args) + c.B * c.S * c.H * c.P * 4  # y is f32
        row = rows[c.path] = timed_row(
            lambda *a: ssd.ssd_scan(*a, chunk=c.chunk),
            lambda *a: ssd.ssd_scan_plain(*a, chunk=c.chunk), args, SSD_TOL,
            None,  # no single PyTorch call computes the scan
            moved, (cbt, c.dtype), per_head_work)
        emit("kernel ssd_scan", shape=[c.B, c.S, c.H, c.P, c.N], chunk=c.chunk,
             dtype=str(c.dtype), dt=c.draw, path=c.path, **row)
    return rows


def phase_causal_conv(gen) -> dict:
    """``timed_row`` of each CONV_CASES row of a main path (x, B and C in one
    launch), its bound the bytes (every input, weight and bias read once,
    every output written once); returned by path."""
    rows = {}
    for c in (c for c in CONV_CASES if c.path):
        convs = conv_inputs(gen, c)
        args = tuple(t for conv in convs for t in conv if t is not None)
        per = 3 if c.bias else 2

        def fn(*a, plain=False, per=per):
            convs = [(*a[i:i + 2], a[i + 2] if per == 3 else None)
                     for i in range(0, len(a), per)]
            return (cc.causal_conv_plain if plain else cc.causal_conv)(*convs)

        moved = nbytes(*args) + sum(nbytes(x) for x, _, _ in convs)  # + the outputs
        row = rows[c.path] = timed_row(
            fn, lambda *a: fn(*a, plain=True), args, None,
            None,  # no single PyTorch call adds the bias and silu
            moved)
        emit("kernel causal_conv", shape=[c.B, c.S, list(c.widths)], taps=c.K, bias=c.bias,
             dtype=str(c.dtype), path=c.path, **row)
    return rows


def phase_skip_gated_norm(gen) -> dict:
    """``timed_row`` of each SGN_CASES row of a main path, held first as the
    card test holds it (``sgn_check``), its bound the bytes (y, x, z, D and
    the scale read once, the output written once); returned by path."""
    rows = {}
    for c in (c for c in SGN_CASES if c.path):
        args = sgn_inputs(gen, c)
        got, rstd = sgn.skip_gated_norm(*args, eps=SGN_EPS, group=c.group, rstd=True)
        sgn_check(args, got, rstd, eps=SGN_EPS, group=c.group, tol=SGN_TOL[c.dtype])
        del got, rstd

        def fn(*a, plain=False, group=c.group):
            return (ssm.skip_gated_norm_plain if plain else sgn.skip_gated_norm)(
                *a, eps=SGN_EPS, group=group)

        row = rows[c.path] = timed_row(
            fn, lambda *a: fn(*a, plain=True), args, SGN_TOL[c.dtype],
            None,  # no single PyTorch call computes the skip and the gated norm
            nbytes(*args, args[3]))  # + the output, z's shape and dtype
        emit("kernel skip_gated_norm", shape=[c.B, c.S, c.H, c.P], group=c.group,
             dtype=str(c.dtype), path=c.path, **row)
    return rows


def phase_prefill(cfg, model, params, gen, shape, bounds=(LOGIT_REL_RMS, LOGIT_MAX_ABS)
                  ) -> dict:
    """One timed prefill through the kernels, held to the reference path.
    A MoE config's routing is recorded on both paths: the pairs capacity
    dropped on each, and the tokens whose top-k expert sets differ."""
    batch = draw_batch(cfg, gen, *shape)
    model.prefill(params, batch)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    with mlp.record_routing() as routing:
        t0 = time.perf_counter()
        logits = model.prefill(params, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = counts()
    MEASURED[f"prefill {cfg.name}"] = dt
    n_attn = sum(cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    want = want_counts(n_attn, cfg.n_layers - n_attn, moe_layers(cfg, cfg.n_layers))
    if launches != want:
        raise AssertionError(f"one prefill launched {launches}, expected {want}")
    with mlp.record_routing() as ref_routing:
        ref = Model(cfg, impl="reference", device="cuda").forward(params, batch)
    moe = {}
    if cfg.n_experts:
        T = shape[0] * shape[1]
        check = moe_logit_check("prefill kernel vs reference", logits, ref,
                                [r["idx"] for r in routing],
                                [r["idx"] for r in ref_routing], bounds)
        moe = {"capacity": mlp.moe_capacity(cfg, T), "moe_layers": len(routing),
               "pairs": T * cfg.top_k * len(routing),
               "dropped_pairs": sum(int(r["dropped"]) for r in routing),
               "reference_dropped_pairs": sum(int(r["dropped"]) for r in ref_routing)}
    else:
        check = logit_check("prefill kernel vs reference", logits, ref, bounds)
    emit("prefill", arch=cfg.name, batch=list(shape),
         inputs={k: [list(v.shape), str(v.dtype)] for k, v in batch.items()},
         layers=cfg.n_layers, params=sum(t.numel() for t in _leaves(params)),
         launches=launches, seconds=dt, tokens_per_s=shape[0] * shape[1] / dt,
         **moe, **check)
    return launches


def topk_flips(a, b):
    """The tokens whose top-k expert sets differ between two routings."""
    return (a.sort(-1).values != b.sort(-1).values).any(-1).sum()


def moe_plain(cfg, p, x):
    """The capacity dispatch written as a plain loop over experts, in f32:
    the router as ``moe_fwd``'s, then for each expert the first C (token,
    slot) pairs routed to it in (token, slot) order, each through the
    expert's SwiGLU; a token's output is the weighted sum of its kept
    pairs' outputs.  Returns (y (B, S, D) in x's dtype, pairs dropped)."""
    B, S, D = x.shape
    T, E, K = B * S, cfg.experts, cfg.top_k
    C = mlp.moe_capacity(cfg, T)
    xf = x.reshape(T, D)
    logits = xf.float() @ p["router"]["w"]
    if cfg.n_experts_padded > cfg.n_experts:
        logits[:, cfg.n_experts:] = -1e30
    w, idx = torch.sort(torch.softmax(logits, -1), dim=-1, descending=True, stable=True)
    w, idx = w[:, :K], idx[:, :K]
    w = (w / w.sum(-1, keepdim=True).clamp_min(1e-9)).to(x.dtype).float()
    y = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    dropped = 0
    for e in range(E):
        tok, slot = (idx == e).nonzero(as_tuple=True)  # in (token, slot) order
        dropped += max(0, len(tok) - C)
        tok, slot = tok[:C], slot[:C]
        h = xf[tok].float()
        g = F.silu(h @ p["wg"][e].float()) * (h @ p["wu"][e].float())
        y.index_add_(0, tok, (g @ p["wo"][e].float()) * w[tok, slot, None])
    return y.to(x.dtype).reshape(B, S, D), dropped


def equal_plain(seen: dict) -> bool:
    """Each dispatch kernel, on the arguments in ``seen``, equals its plain
    version bit for bit."""
    return all(torch.equal(getattr(md, name)(*args), getattr(md, f"{name}_plain")(*args))
               for name, args in seen.items())


def dispatch_kernel_rows(seen: dict) -> dict:
    """``timed_row`` of each dispatch kernel on the arguments in ``seen``
    (bit for bit), its bound the bytes (every buffer row written once and each kept pair's row
    read once by the gather; each kept pair's expert row read once and y
    written once by the combine)."""
    xf, src = seen["moe_gather"]
    eout, slot, w, local = seen["moe_combine"]
    row = xf.shape[1] * xf.element_size()
    kept = int((src >= 0).sum())
    return {"moe_gather": timed_row(md.moe_gather, md.moe_gather_plain, seen["moe_gather"], None,
                                    None, src.shape[0] * row + kept * row + nbytes(src)),
            "moe_combine": timed_row(md.moe_combine, md.moe_combine_plain, seen["moe_combine"],
                                     None, None,
                                     kept * row + w.shape[0] * row + nbytes(slot, w, local))}


def phase_moe_dispatch(cfg, params, gen, shape) -> dict:
    """The capacity dispatch (``mlp.moe_fwd``) of the first MoE layer on the
    card, at the prefill's token count, against ``moe_plain``: N(0, 1)
    inputs in the model's dtype, the layer's own weights.  Its kernel path
    is held to the reference's bit for bit and each of its two kernels to
    its plain version; at each DISPATCH_CASES row of this arch's main path,
    the kernels are then timed on the layer's calls
    (``dispatch_kernel_rows``)."""
    j = next(j for j in range(cfg.block_period) if cfg.is_moe_layer(j))
    p = {k: v[0] if torch.is_tensor(v) else {"w": v["w"][0]}
         for k, v in params["blocks"][j]["moe"].items() if k != "shared"}
    x = randn(gen, (*shape, cfg.d_model), params["embed"]["w"].dtype)
    ctx = ParallelCtx.single()
    with mlp.record_routing() as routing, recorded_dispatch() as seen:
        out = mlp.moe_fwd(cfg, ctx, p, x, impl="kernel")
    same = torch.equal(out, mlp.moe_fwd(cfg, ctx, p, x))
    ref, dropped = moe_plain(cfg, p, x)
    torch.cuda.synchronize()
    row = {"arch": cfg.name, "tokens": shape[0] * shape[1], "experts": cfg.experts,
           "top_k": cfg.top_k, "capacity": mlp.moe_capacity(cfg, shape[0] * shape[1]),
           "dropped_pairs": int(routing[0]["dropped"]), "plain_dropped_pairs": dropped,
           "tol": MOE_DISPATCH_TOL, "kernel_path_equals_reference": same,
           "kernels_equal_plain": equal_plain(seen),
           "rel_rms_err": ((out.float() - ref.float()).norm() / ref.float().norm()).item()}
    row["max_abs_err"] = close(out, ref, MOE_DISPATCH_TOL)
    for impl in ("kernel", "reference"):
        row[f"call_ms_{impl}"] = call_ms(
            lambda a, impl=impl: mlp.moe_fwd(cfg, ctx, p, a, impl=impl), (x,), iters=4)
    del seen
    for c in (c for c in DISPATCH_CASES if c.path == cfg.name):
        layer, lp = cfg, p
        if not c.padded:  # the published experts, as the benchmark's layer
            layer = dataclasses.replace(cfg, n_experts_padded=0)
            lp = {**p, "router": {"w": p["router"]["w"][:, :cfg.n_experts].contiguous()},
                  **{k: p[k][:cfg.n_experts] for k in ("wg", "wu", "wo")}}
        T = c.tokens[0] * c.tokens[1]
        row["kernels_at"] = {"tokens": list(c.tokens), "experts": layer.experts,
                             "capacity": mlp.moe_capacity(layer, T)}
        with recorded_dispatch() as seen:
            mlp.moe_fwd(layer, ctx, lp, randn(gen, (*c.tokens, cfg.d_model), x.dtype),
                        impl="kernel")
        row["kernels"] = dispatch_kernel_rows(seen)
        del seen, lp
    emit("moe dispatch", **row)
    if row["dropped_pairs"] != dropped:
        raise AssertionError(f"the dispatch dropped {row['dropped_pairs']} pairs, the "
                             f"plain loop {dropped}")
    if not (same and row["kernels_equal_plain"]):
        raise AssertionError("the dispatch's kernel path differs from the reference's")
    return row


def phase_serve(cfg, model, params, *, check_len: int = 0,
                bounds=(LOGIT_REL_RMS, LOGIT_MAX_ABS)) -> None:
    """The engine answers four requests.  Then the engine path
    (``decode_step`` token by token) is held to the kernel prefill: at the
    last position of the first prompt, or, with ``check_len``, at every
    position of a sequence of that many tokens.  Not for a MoE config: its
    capacity counts the tokens routed together, so a prefill may drop pairs
    that one-token decode steps keep (the decode step is held to the JAX
    reference's on the CPU, tests/test_torch_moe.py)."""
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab, size=rng.integers(3, 9)).tolist()
               for _ in range(4)]
    eng = Engine(model, params, ServeConfig(max_len=64, batch_slots=2))
    reset_counts()
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new=8) for p in prompts]
    results = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    engine_launches = counts()
    if sorted(results) != ids or any(len(results[i]) != 8 for i in ids):
        raise AssertionError(f"engine results incomplete: {results}")
    vocab_ok = all(0 <= t < cfg.vocab_p for i in ids for t in results[i])
    if not vocab_ok:
        raise AssertionError(f"token out of vocabulary: {results}")
    total = sum(len(v) for v in results.values())
    if cfg.n_experts:
        emit("serve", arch=cfg.name, requests=len(ids), prompt_lens=[len(p) for p in prompts],
             max_new=8, slots=2, generated=total, seconds=dt, tokens_per_s=total / dt,
             launches=engine_launches, decode_capacity=mlp.moe_capacity(cfg, 2))
        return
    seq = (rng.integers(1, cfg.vocab, size=check_len).tolist() if check_len
           else prompts[0])
    reset_counts()
    batch = {"tokens": torch.tensor([seq], device="cuda")}
    if cfg.frontend == "vision_patches":  # text only: a prefix of no patches
        batch["vision_embeds"] = torch.empty((1, 0, cfg.frontend_dim), dtype=model.dtype,
                                             device="cuda")
    pre = model.prefill(params, batch)[0]
    caches = model.init_cache(1, max(64, len(seq)))
    steps = []
    for pos, t in enumerate(seq):
        logits, caches = model.decode_step(params, torch.tensor([t], device="cuda"),
                                           caches, pos)
        steps.append(logits[0])
    if check_len:
        check = logit_check("prefill vs decode_step", pre, torch.stack(steps), bounds)
    else:
        check = logit_check("prefill vs decode_step", pre[-1], steps[-1], bounds)
    check.update(tokens=len(seq), positions=len(seq) if check_len else 1,
                 launches=counts())
    emit("serve", arch=cfg.name, requests=len(ids), prompt_lens=[len(p) for p in prompts],
         max_new=8, slots=2, generated=total, seconds=dt, tokens_per_s=total / dt,
         launches=engine_launches, prefill_vs_decode=check)


def host_cpu() -> str:
    """The host CPU as ``/proc/cpuinfo`` names it (a virtual machine may
    hide the model name; family and model number stay), and its logical
    CPUs."""
    info: dict = {}
    for line in Path("/proc/cpuinfo").read_text().splitlines():
        key, _, value = line.partition(":")
        info.setdefault(key.strip(), value.strip())
    return (f"{info.get('model name', platform.machine())} (family "
            f"{info.get('cpu family', '?')}, model {info.get('model', '?')}), "
            f"{os.cpu_count()} logical CPUs")


def phase_verify(card: str) -> None:
    """The port's verifier proves each of VERIFY_PLANS at full width and
    depth (CONFIG; tp and sp plans trace 3 block periods and stamp them to
    the full depth), with the JAX reference's memo hits.  Host seconds on
    the machine that has the card: the verifier executes nothing on it."""
    cpu, failed = host_cpu(), []
    # the process's first make_fx pays for imports and dispatcher caches:
    # time it apart, on a small pair, so each arch's trace_s is steady state
    t0 = time.perf_counter()
    with Session() as session:
        session.verify("llama3_8b", Plan(tp=2, smoke=True))
    emit("verify warm-up", arch="llama3_8b SMOKE", tp=2, seconds=time.perf_counter() - t0,
         host_cpu=cpu, card=card)
    plans = {"tp-forward": {}, "tp-decode": {"mode": "decode"}, "sp-forward": {"sp": True}}
    for (arch, kind, size), jax_memo_hits in VERIFY_PLANS.items():
        plan = (Plan(dp=size) if kind == "dp-forward" else Plan(ep=size)
                if kind == "ep-moe-forward" else Plan(tp=size, **plans[kind]))
        with Session() as session:
            rep = session.verify(arch, plan)
        emit("verify", arch=arch, scenario=kind, size=size, verified=rep.verified,
             stamped=rep.stamped, base_nodes=rep.num_base_nodes,
             dist_nodes=rep.num_dist_nodes, facts=rep.num_facts,
             memo_hits=rep.memo.memo_hits, jax_memo_hits=jax_memo_hits,
             trace_s=rep.timings.trace_s, stamp_s=rep.timings.stamp_s,
             rules_s=rep.timings.rules_s, total_s=rep.elapsed_s, host_cpu=cpu, card=card,
             bug_sites=[{"src": b.src, "category": b.category} for b in rep.bug_sites[:3]])
        # dp-forward traces the full depth, as the reference does
        if not (rep.verified and (rep.stamped or kind == "dp-forward")):
            failed.append(f"{arch} {kind} {size}: not verified from a stamped trace")
        if rep.memo.memo_hits != jax_memo_hits:
            failed.append(f"{arch} {kind} {size}: {rep.memo.memo_hits} memo hits, the "
                          f"reference takes {jax_memo_hits}")
    for (arch, flags), (kw, jax_memo_hits) in VERIFY_MULTI.items():
        with Session() as session:
            rep = session.verify(arch, Plan(**kw))
        emit("verify", arch=arch, plan=flags, verified=rep.verified,
             scenarios=[{k: r[k] for k in ("scenario", "verified", "num_facts",
                                           "num_dist_nodes", "elapsed_s", "stamped")}
                        for r in rep.scenarios],
             base_nodes=rep.num_base_nodes, dist_nodes=rep.num_dist_nodes,
             facts=rep.num_facts, memo_hits=rep.cache.memo_hits,
             jax_memo_hits=jax_memo_hits, trace_s=rep.timings.trace_s,
             rules_s=rep.timings.rules_s, total_s=rep.elapsed_s, host_cpu=cpu, card=card,
             bug_sites=[{"src": b.src, "category": b.category} for b in rep.bug_sites[:3]])
        if not rep.verified or rep.cache.memo_hits != jax_memo_hits:
            failed.append(f"{arch} {flags}: verified {rep.verified}, "
                          f"{rep.cache.memo_hits} memo hits, the reference takes "
                          f"{jax_memo_hits}")
    if failed:
        raise AssertionError(f"verify phase: {failed}")


def phase_campaign() -> None:
    """Every registered injector on each (arch, scenario) pair of
    CAMPAIGN_REFERENCE at tp 4 (dp 2); each cell's outcome must be the JAX
    reference's, localization included: a detected cell is localized
    ("detected") or not ("mislocalized") as in the reference; and the
    cells the lint tier flags baseline-free must be CAMPAIGN_LINT's."""
    failed = []
    for (arch, kind), want in CAMPAIGN_REFERENCE.items():
        t0 = time.perf_counter()
        rep = run_campaign([arch], tp=TP_SIZE, dp=DP_SIZE, scenarios=[kind])
        seconds = time.perf_counter() - t0
        got = {c.injector: c.outcome for c in rep.cells}
        localized = sum(c.localized for c in rep.cells)
        lint = tuple(sorted(c.injector for c in rep.cells if c.lint_detected))
        emit("campaign", arch=arch, tp=TP_SIZE, dp=DP_SIZE, scenario=kind,
             detected=rep.detected,
             missed=rep.missed, false_positives=rep.false_positives, localized=localized,
             cells=got, lint_detected=lint, seconds=seconds)
        if got != want or not rep.ok or lint != CAMPAIGN_LINT[arch, kind]:
            failed.append((arch, kind, got, lint))
    if failed:
        raise AssertionError(f"campaign cells differ from the reference: {failed}")


def single_device_logits(cfg, seed: int, tokens: torch.Tensor) -> torch.Tensor:
    """The single-device forward of ``tokens`` through the kernels, f32
    logits on the card, the weights freed after it."""
    with torch.inference_mode():
        model = Model(cfg, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(seed))
        ref = model.forward(params, {"tokens": tokens.cuda()}).float()
        del params
        torch.cuda.empty_cache()
    return ref


def dp_rank(rank: int, world: int, cfg, seed: int, tokens: torch.Tensor) -> dict:
    """One rank of the dp_forward phase (runs in a spawned process): a
    warm-up forward, then one forward with the kernels' counts read around
    it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    spmd.dp_forward(rank, world, cfg, seed, tokens, impl="kernel", device="cuda")
    reset_counts()
    out = spmd.dp_forward(rank, world, cfg, seed, tokens, impl="kernel", device="cuda")
    return {**out, "launches": counts()}


def phase_dp_forward(gen) -> list:
    """The verifier's dp-forward program on DP_SIZE gloo ranks that share
    the card: gemma_2b at full width and depth, bf16, through the kernels;
    each rank draws the whole single-device parameter set from one seed and
    runs the forward pass on its rows of DP_TOKENS.  Each rank's logits are
    held to its rows of the single-device forward of the whole batch."""
    cfg = get_config("gemma_2b")
    seed = int(torch.randint(0, 2**31, (1,), generator=gen, device="cuda").item())
    tokens = torch.randint(0, cfg.vocab, DP_TOKENS, generator=gen, device="cuda").cpu()
    ref = single_device_logits(cfg, seed, tokens)
    t0 = time.perf_counter()
    ranks = spmd.run(dp_rank, DP_SIZE, (cfg, seed, tokens), timeout=600)
    seconds = time.perf_counter() - t0
    rows = DP_TOKENS[0] // DP_SIZE
    checks = [logit_check(f"dp_forward rank {r} vs single device",
                          out["logits"].cuda(), ref[r * rows:(r + 1) * rows], DP_LOGIT_BOUNDS)
              for r, out in enumerate(ranks)]
    launches = [r["launches"] for r in ranks]
    want = want_counts(cfg.n_layers)
    emit("dp_forward", arch=cfg.name, dp=DP_SIZE, layers=cfg.n_layers,
         tokens=list(DP_TOKENS), dtype=cfg.dtype, backend="gloo",
         flash_shape_per_rank=[rows, cfg.heads, cfg.kv_heads, DP_TOKENS[1], DP_TOKENS[1],
                               cfg.hd], launches_per_rank=launches,
         forward_ms_per_rank=[r["ms"] for r in ranks], seconds=seconds, per_rank=checks)
    if any(n != want for n in launches):
        raise AssertionError(f"each rank's forward launched {launches}, expected {want}")
    return launches


def tp_rank(rank: int, world: int, cfg, seed: int, tokens: torch.Tensor,
            modes: tuple = (False,)) -> dict:
    """One rank of the tp_forward phase (runs in a spawned process), for each
    of ``modes`` (sequence parallelism off, on): a warm-up forward, then one
    forward with the kernels' counts read around it; rank 0 gathers the
    vocab shards of the logits (gloo, on the host)."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    for sp in modes:
        spmd.tp_forward(rank, world, cfg, seed, tokens, impl="kernel", device="cuda", sp=sp)
        reset_counts()
        out = spmd.tp_forward(rank, world, cfg, seed, tokens, impl="kernel", device="cuda",
                              sp=sp)
        launches = counts()
        shards = ([torch.empty_like(out["logits"]) for _ in range(world)] if rank == 0
                  else None)
        dist.gather(out["logits"], shards, dst=0)
        logits = torch.cat(shards, dim=-1) if rank == 0 else None
        runs["sp" if sp else "tp"] = {"ms": out["ms"], "launches": launches,
                                      "logits": logits, "dropped": out["dropped"],
                                      "topk": out["topk"]}
    return runs


def phase_tp_forward(gen, arch: str = "llama3_8b", layers: int = TP_LAYERS,
                     bounds=TP_LOGIT_BOUNDS, sp: bool = False):
    """The per-rank TP program the verifier proves, on four gloo ranks that
    share the card (NCCL refuses two ranks on one device; gloo stages the
    all_reduces through the host), ``arch`` at full width with ``layers``
    layers, bf16, through the kernels.  Each rank draws the single-device
    weights from one seed and keeps its shard (``param_specs``): a MoE
    config's experts split over the ranks, each running the capacity
    dispatch for its own (``first = rank * E_loc``), with capacity from the
    global token count; the pairs each rank's experts dropped are printed
    beside the single device's.  With ``sp`` the same ranks then run the
    sequence-parallel program the verifier's sp-forward proves (its
    sequence reduce_scatters and all_gathers through the host), held to the
    single device and to the TP program's logits (its ``sp_forward``
    line); returns (TP launches, SP launches or None)."""
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    seed = int(torch.randint(0, 2**31, (1,), generator=gen, device="cuda").item())
    tokens = torch.randint(0, cfg.vocab, TP_TOKENS, generator=gen, device="cuda").cpu()
    torch.cuda.synchronize()
    with torch.inference_mode(), mlp.record_routing() as routing:
        model = Model(cfg, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(seed))
        ref = model.forward(params, {"tokens": tokens.cuda()}).float()
        dropped = sum(int(r["dropped"]) for r in routing)
        del params
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    runs = spmd.run(tp_rank, TP_SIZE, (cfg, seed, tokens, (False, True) if sp else (False,)),
                    timeout=600)
    seconds = time.perf_counter() - t0
    ranks = [r["tp"] for r in runs]
    launches = [r["launches"] for r in ranks]
    name = f"tp_forward {arch} TP-4 vs single device"
    check = (moe_logit_check(name, ranks[0]["logits"].cuda(), ref, ranks[0]["topk"],
                             [r["idx"] for r in routing], bounds) if cfg.n_experts
             else logit_check(name, ranks[0]["logits"].cuda(), ref, bounds))
    moe = ({"experts_per_rank": cfg.experts // TP_SIZE,
            "dropped_pairs_per_rank": [r["dropped"] for r in ranks],
            "single_device_dropped_pairs": dropped} if cfg.n_experts else {})
    want = want_counts(layers, moe=moe_layers(cfg, layers))
    emit("tp_forward", arch=cfg.name, tp=TP_SIZE, layers=layers, tokens=list(TP_TOKENS),
         dtype=cfg.dtype, backend="gloo", flash_shape_per_rank=[
             TP_TOKENS[0], cfg.heads // TP_SIZE, cfg.kv_heads // TP_SIZE, TP_TOKENS[1],
             TP_TOKENS[1], cfg.hd], launches_per_rank=launches,
         forward_ms_per_rank=[r["ms"] for r in ranks], seconds=seconds, **moe, **check)
    if any(n != want for n in launches):
        raise AssertionError(f"each rank's forward launched {launches}, expected {want}")
    if not sp:
        return launches, None
    sp_ranks = [r["sp"] for r in runs]
    sp_launches = [r["launches"] for r in sp_ranks]
    got = sp_ranks[0]["logits"].cuda()
    emit("sp_forward", arch=cfg.name, tp=TP_SIZE, layers=layers, tokens=list(TP_TOKENS),
         dtype=cfg.dtype, backend="gloo", collectives="sequence reduce_scatter and "
         "all_gather of CUDA tensors through the host", flash_shape_per_rank=[
             TP_TOKENS[0], cfg.heads // TP_SIZE, cfg.kv_heads // TP_SIZE, TP_TOKENS[1],
             TP_TOKENS[1], cfg.hd], launches_per_rank=sp_launches,
         forward_ms_per_rank=[r["ms"] for r in sp_ranks], seconds=seconds,
         vs_single_device=logit_check(f"sp_forward {arch} SP TP-4 vs single device", got,
                                      ref, bounds),
         vs_tp_forward=logit_check(f"sp_forward {arch} SP vs TP program", got,
                                   ranks[0]["logits"].cuda(), bounds))
    if any(n != want for n in sp_launches):
        raise AssertionError(f"each rank's SP forward launched {sp_launches}, "
                             f"expected {want}")
    return launches, sp_launches


def phase_sp_forward(gen):
    """The sp_forward check on its own: the TP program, then the SP one."""
    return phase_tp_forward(gen, sp=True)


def tp_decode_rank(rank: int, world: int, cfg, seed: int, tokens: torch.Tensor) -> dict:
    """One rank of the tp_decode phase (runs in a spawned process): the
    decode step the verifier's tp-decode scenario proves, fed ``tokens`` one
    position at a time, with the kernels' counts read around it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_counts()
    out = spmd.tp_decode(rank, world, cfg, seed, tokens, TP_DECODE_MAX_LEN, device="cuda")
    return {**out, "launches": counts()}


def phase_tp_decode(gen) -> list:
    """The per-rank serving step on four gloo ranks that share the card,
    llama3_8b at full width with TP_LAYERS layers, bf16, batch
    TP_DECODE_BATCH: a TP_DECODE_PROMPT-token prompt fed position by
    position, then TP_DECODE_STEPS more steps (tokens drawn in advance).
    Every step's logits (the ranks' vocab shards side by side) and each
    rank's final cache shards (``cache_specs``) are held to the
    single-device ``decode_step`` on the card.  Decode runs no kernel, as in
    the JAX package (``chunked_attention`` on the caches)."""
    cfg = dataclasses.replace(get_config("llama3_8b"), n_layers=TP_LAYERS)
    seed = int(torch.randint(0, 2**31, (1,), generator=gen, device="cuda").item())
    n = TP_DECODE_PROMPT + TP_DECODE_STEPS
    tokens = torch.randint(0, cfg.vocab, (TP_DECODE_BATCH, n), generator=gen,
                           device="cuda").cpu()
    with torch.inference_mode():
        model = Model(cfg, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(seed))
        caches = model.init_cache(TP_DECODE_BATCH, TP_DECODE_MAX_LEN)
        steps = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(n):
            pos = torch.tensor(t, dtype=torch.int64).cuda()
            logits, caches = model.decode_step(params, tokens[:, t].cuda(), caches, pos)
            steps.append(logits.float())
        torch.cuda.synchronize()
        single_ms = (time.perf_counter() - t0) * 1e3 / n
        ref = torch.stack(steps)
        del params
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spmd.run(tp_decode_rank, TP_SIZE, (cfg, seed, tokens), timeout=600)
    seconds = time.perf_counter() - t0
    got = torch.cat([r["logits"] for r in ranks], dim=-1).cuda()
    check = logit_check("tp_decode TP-4 vs single device", got, ref, TP_DECODE_BOUNDS)
    specs = cache_specs(caches)
    cache_rel = {}
    for rank, out in enumerate(ranks):
        want = shard_params(caches, specs, rank, TP_SIZE)
        for j, (block, wblock) in enumerate(zip(out["caches"], want)):
            for name in sorted(wblock):
                a, b = block[name].cuda().float(), wblock[name].float()
                if a.shape != b.shape or not torch.isfinite(a).all():
                    raise AssertionError(f"rank {rank} cache {j}/{name}: shape "
                                         f"{tuple(a.shape)} or non-finite values")
                key = f"{j}/{name}"
                cache_rel[key] = max(cache_rel.get(key, 0.0),
                                     ((a - b).norm() / b.norm()).item())
    launches = [r["launches"] for r in ranks]
    emit("tp_decode", arch=cfg.name, tp=TP_SIZE, layers=TP_LAYERS,
         batch=TP_DECODE_BATCH, prompt=TP_DECODE_PROMPT, steps=TP_DECODE_STEPS,
         max_len=TP_DECODE_MAX_LEN, dtype=cfg.dtype, backend="gloo",
         ms_per_step_per_rank=[r["ms"] for r in ranks], single_device_ms_per_step=single_ms,
         launches_per_rank=launches,
         seconds=seconds, cache_rel_rms_err=cache_rel,
         tol_cache_rel_rms=TP_DECODE_CACHE_REL_RMS, **check)
    if max(cache_rel.values()) > TP_DECODE_CACHE_REL_RMS:
        raise AssertionError(f"tp_decode cache shards differ from the single device's: "
                             f"{cache_rel}")
    want = want_counts()
    if any(n != want for n in launches):
        raise AssertionError(f"a rank's decode launched {launches}, expected {want}")
    return launches


def cp_rank(rank: int, world: int, cfg, seed: int, tokens: torch.Tensor, caches) -> dict:
    """One rank of the cp_decode phase (runs in a spawned process): the
    context-parallel decode steps, with the kernels' counts read around
    them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_counts()
    out = spmd.cp_decode(rank, world, cfg, seed, tokens, CP_PROMPT[1], caches, CP_TP,
                         device="cuda")
    return {**out, "launches": counts()}


def prefill_caches(model, params, tokens, max_len: int) -> tuple:
    """The single-device prefill's KV caches (an attention stack): the
    forward pass collects each layer's K/V, after RoPE, and they fill
    positions [0, S) of ``init_cache``'s zeroed buffers of ``max_len``."""
    kv: list = []
    model.forward(params, {"tokens": tokens}, kv_out=kv)
    caches = model.init_cache(tokens.shape[0], max_len)
    for n, (k, v) in enumerate(kv):
        i, j = divmod(n, model.cfg.block_period)
        caches[j]["k"][i, :, :, :k.shape[2]] = k
        caches[j]["v"][i, :, :, :v.shape[2]] = v
    return caches


def phase_cp_decode(gen) -> list:
    """The context-parallel decode step on four gloo ranks that share the
    card, a (data, model) = (CP_SIZE, CP_TP) mesh whose data axis cuts the
    KV cache along the sequence: llama3_8b at full width with TP_LAYERS
    layers, bf16.  The single device prefills a CP_PROMPT prompt into caches
    of CP_MAX_LEN positions (``prefill_caches``, reference path); each
    rank keeps its (head, sequence) shard and decodes CP_STEPS tokens from
    position CP_PROMPT[1], the owning shard writing each one, and the
    shards' softmax parts merged over the data axis.  Every step's vocab
    shard of the logits is held to the single-device ``decode_step`` from
    the same caches.  Long-context serving sends this traffic: one
    request's KV cache split along the sequence over devices."""
    cfg = dataclasses.replace(get_config("llama3_8b"), n_layers=TP_LAYERS)
    seed = int(torch.randint(0, 2**31, (1,), generator=gen, device="cuda").item())
    prompt = torch.randint(0, cfg.vocab, CP_PROMPT, generator=gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (CP_PROMPT[0], CP_STEPS), generator=gen,
                           device="cuda").cpu()
    with torch.inference_mode():
        model = Model(cfg, impl="reference", device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(seed))
        t0 = time.perf_counter()
        caches = prefill_caches(model, params, prompt, CP_MAX_LEN)
        prefill_s = _sync_s(t0)
        host = tree_map(lambda t: t.cpu(), caches)
        steps = []
        t0 = time.perf_counter()
        for t in range(CP_STEPS):
            pos = torch.tensor(CP_PROMPT[1] + t, dtype=torch.int64).cuda()
            logits, caches = model.decode_step(params, tokens[:, t].cuda(), caches, pos)
            steps.append(logits.float())
        single_ms = _sync_s(t0) * 1e3 / CP_STEPS
        ref = torch.stack(steps)
        del params, caches, model
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spmd.run(cp_rank, CP_TP * CP_SIZE, (cfg, seed, tokens, host), timeout=600)
    seconds = time.perf_counter() - t0
    v = cfg.vocab_p // CP_TP
    s_loc = CP_MAX_LEN // CP_SIZE
    checks = [{"data": r["data"], "model": r["model"], **logit_check(
        f"cp_decode rank {i} vs single device", r["logits"].cuda(),
        ref[..., r["model"] * v:(r["model"] + 1) * v], TP_LOGIT_BOUNDS)}
        for i, r in enumerate(ranks)]
    launches = [r["launches"] for r in ranks]
    emit("cp_decode", arch=cfg.name, tp=CP_TP, cp=CP_SIZE, layers=TP_LAYERS,
         max_len=CP_MAX_LEN, positions_per_rank=s_loc, prompt=list(CP_PROMPT),
         steps=CP_STEPS, write_shard_by_step=[(CP_PROMPT[1] + t) // s_loc
                                              for t in range(CP_STEPS)],
         dtype=cfg.dtype, backend="gloo", single_device_prefill_s=prefill_s,
         single_device_ms_per_step=single_ms,
         ms_per_step_per_rank=[r["ms"] for r in ranks], launches_per_rank=launches,
         seconds=seconds, per_rank=checks)
    if sorted((c["data"], c["model"]) for c in checks) != [
            (d, m) for d in range(CP_SIZE) for m in range(CP_TP)]:
        raise AssertionError(f"the ranks' mesh coordinates: {checks}")
    want = want_counts()
    if any(n != want for n in launches):
        raise AssertionError(f"a rank's CP decode launched {launches}, expected {want}")
    return launches


def dp_grad_rank(rank: int, world: int, cfg, seed: int, tokens: torch.Tensor) -> dict:
    """One rank of the dp_grad phase's run (runs in a spawned process): the
    parameters drawn whole from ``seed``, ``spmd.dp_grad`` on this rank's
    rows (a warm-up call, then one timed with the kernels' counts read
    around it), then the single device's full-batch gradient from the same
    parameters, on this rank, and each leaf's error against it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    params = Model(cfg, impl="reference", device="cuda").init(
        torch.Generator(device="cuda").manual_seed(seed))
    model = Model(cfg, ParallelCtx(dp_axis=("data",), dp_size=world), impl="reference",
                  device="cuda")
    rows = tokens.shape[0] // world
    batch = {"tokens": tokens[rank * rows:(rank + 1) * rows].cuda()}
    spmd.dp_grad(model, params, batch)  # warm-up, its gradients dropped
    reset_counts()
    t0 = time.perf_counter()
    grads = spmd.dp_grad(model, params, batch)
    ms = _sync_s(t0) * 1e3
    launches = counts()
    want = spmd.sum_grads(Model(cfg, impl="reference", device="cuda"), params,
                          {"tokens": tokens.cuda()})
    rel = {k: float((g - want_g).abs().max()) / max(float(want_g.abs().max()), 1e-30)
           for (k, g), want_g in zip(_keyed(grads).items(), tree_leaves(want))}
    finite = all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
    return {"ms": ms, "launches": launches, "rel_err": rel, "finite": finite}


def phase_dp_grad_verify(card: str) -> None:
    """dp-grad's verify part: the port's Session proves Plan.grad(dp=DP_SIZE)
    for each of DP_GRAD_VERIFY at full width, DP_GRAD_VERIFY_LAYERS layers,
    seq 8, on the card's host (the gradient traced through
    ``torch.autograd``, the per-rank side ``spmd.dp_grad``)."""
    cpu, failed = host_cpu(), []
    for arch in DP_GRAD_VERIFY:
        with Session() as session:
            rep = session.verify(arch, Plan.grad(dp=DP_SIZE, layers=DP_GRAD_VERIFY_LAYERS,
                                                 seq=8))
        emit("dp_grad", part="verify", arch=arch, dp=DP_SIZE, layers=DP_GRAD_VERIFY_LAYERS,
             seq=8,
             verified=rep.verified, base_nodes=rep.num_base_nodes,
             dist_nodes=rep.num_dist_nodes, facts=rep.num_facts,
             trace_s=rep.timings.trace_s, rules_s=rep.timings.rules_s,
             total_s=rep.elapsed_s, host_cpu=cpu, card=card, torch=torch.__version__,
             bug_sites=[{"src": b.src, "op": b.op, "category": b.category,
                         "detail": b.detail[:300]} for b in rep.bug_sites[:3]])
        if not rep.verified:
            failed.append(arch)
    if failed:
        raise AssertionError(f"dp_grad: Plan.grad(dp={DP_SIZE}) not verified for {failed}")


def phase_dp_grad_run(gen) -> list:
    """dp-grad's run part: the proved ``spmd.dp_grad`` on DP_SIZE gloo ranks
    sharing the card, llama3_8b at full width with DP_GRAD_LAYERS layers,
    f32, TF32 off, tokens DP_GRAD_TOKENS, a row a rank; each rank's psummed
    gradient against the single device's full-batch gradient, leaf by leaf,
    within DP_GRAD_REL (the loss is a sum: no ``1 / dp``)."""
    cfg = dataclasses.replace(get_config("llama3_8b"), n_layers=DP_GRAD_LAYERS,
                              dtype="float32")
    seed = int(torch.randint(0, 2**31, (1,), generator=gen, device="cuda").item())
    tokens = torch.randint(0, cfg.vocab, DP_GRAD_TOKENS, generator=gen, device="cuda").cpu()
    t0 = time.perf_counter()
    ranks = spmd.run(dp_grad_rank, DP_SIZE, (cfg, seed, tokens), timeout=600)
    seconds = time.perf_counter() - t0
    launches = [r["launches"] for r in ranks]
    worst = [max(r["rel_err"].values()) for r in ranks]
    emit("dp_grad", part="run", arch=cfg.name, dp=DP_SIZE, layers=DP_GRAD_LAYERS,
         tokens=list(DP_GRAD_TOKENS), dtype=cfg.dtype, backend="gloo",
         ms_per_rank=[r["ms"] for r in ranks], launches_per_rank=launches,
         worst_leaf_rel_err_per_rank=worst, tol_rel=DP_GRAD_REL,
         rel_err_per_rank=[r["rel_err"] for r in ranks], seconds=seconds)
    if not all(r["finite"] for r in ranks) or max(worst) > DP_GRAD_REL:
        raise AssertionError(f"dp_grad: a rank's psummed gradient is not the full "
                             f"batch's: worst leaf errors {worst}")
    want = want_counts()
    if any(n != want for n in launches):
        raise AssertionError(f"a rank's dp_grad launched {launches}, expected {want}")
    return launches


def tpdp_rank(rank: int, world: int, cfg, seed: int, tokens: torch.Tensor) -> dict:
    """One rank of the tpdp_forward phase (runs in a spawned process): a
    warm-up forward, then one forward with the kernels' counts read around
    it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    spmd.tpdp_forward(rank, world, cfg, seed, tokens, TPDP_TP)
    reset_counts()
    out = spmd.tpdp_forward(rank, world, cfg, seed, tokens, TPDP_TP)
    return {**out, "launches": counts()}


def phase_tpdp_forward(gen) -> list:
    """The verifier's tpdp-forward program on four gloo ranks that share the
    card: a (data, model) = (4 / TPDP_TP, TPDP_TP) mesh, llama3_8b at full
    width with TP_LAYERS layers, bf16, through the kernels; each rank draws
    the single-device weights from one seed, keeps the shard of its model
    coordinate and runs the forward on the rows of its data coordinate,
    the model-axis all_reduces on its model group.  Each rank's logits are
    held to its rows and vocab columns of the single-device forward."""
    cfg = dataclasses.replace(get_config("llama3_8b"), n_layers=TP_LAYERS)
    seed = int(torch.randint(0, 2**31, (1,), generator=gen, device="cuda").item())
    tokens = torch.randint(0, cfg.vocab, TPDP_TOKENS, generator=gen, device="cuda").cpu()
    ref = single_device_logits(cfg, seed, tokens)
    world, dp = TP_SIZE, TP_SIZE // TPDP_TP
    t0 = time.perf_counter()
    ranks = spmd.run(tpdp_rank, world, (cfg, seed, tokens), timeout=600)
    seconds = time.perf_counter() - t0
    rows, v = TPDP_TOKENS[0] // dp, cfg.vocab_p // TPDP_TP
    checks = [{"data": r["data"], "model": r["model"], **logit_check(
        f"tpdp_forward rank {i} vs single device", r["logits"].cuda(),
        ref[r["data"] * rows:(r["data"] + 1) * rows, :, r["model"] * v:(r["model"] + 1) * v],
        TP_LOGIT_BOUNDS)} for i, r in enumerate(ranks)]
    launches = [r["launches"] for r in ranks]
    want = want_counts(TP_LAYERS)
    emit("tpdp_forward", arch=cfg.name, tp=TPDP_TP, dp=dp, layers=TP_LAYERS,
         tokens=list(TPDP_TOKENS), dtype=cfg.dtype, backend="gloo",
         flash_shape_per_rank=[rows, cfg.heads // TPDP_TP, cfg.kv_heads // TPDP_TP,
                               TPDP_TOKENS[1], TPDP_TOKENS[1], cfg.hd],
         launches_per_rank=launches, forward_ms_per_rank=[r["ms"] for r in ranks],
         seconds=seconds, per_rank=checks)
    if sorted((c["data"], c["model"]) for c in checks) != [
            (d, m) for d in range(dp) for m in range(TPDP_TP)]:
        raise AssertionError(f"the ranks' mesh coordinates: {checks}")
    if any(n != want for n in launches):
        raise AssertionError(f"each rank's forward launched {launches}, expected {want}")
    return launches


def pipe_rank(rank: int, world: int, cfg, seed: int, tokens: torch.Tensor) -> dict:
    """One rank of the pipeline_forward phase (runs in a spawned process): a
    warm-up pass, then one pass with the kernels' counts read around it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    spmd.pipeline_tp_forward(rank, world, cfg, seed, tokens, PIPE_STAGES, PIPE_MICRO)
    reset_counts()
    out = spmd.pipeline_tp_forward(rank, world, cfg, seed, tokens, PIPE_STAGES, PIPE_MICRO)
    return {**out, "launches": counts()}


def phase_pipeline_forward(gen) -> list:
    """The pipeline x TP program on four gloo ranks that share the card: a
    ("pod", "model") = (PIPE_STAGES, 4 / PIPE_STAGES) mesh, llama3_8b at full
    width with PIPE_LAYERS layers, bf16, through the kernels.  Each rank
    keeps its model shard of its stage's layers; every rank embeds the
    PIPE_MICRO microbatches, runs them through ``pipeline_forward`` (each
    stage the program the ``stage`` scenario proves, idle ticks on zeros
    included, so each rank runs its stage's layers on every one of the
    PIPE_MICRO + PIPE_STAGES - 1 ticks), then the final norm and the head.
    Every rank's logits are held to its vocab columns of the single-device
    forward."""
    cfg = dataclasses.replace(get_config("llama3_8b"), n_layers=PIPE_LAYERS)
    seed = int(torch.randint(0, 2**31, (1,), generator=gen, device="cuda").item())
    tokens = torch.randint(0, cfg.vocab, (PIPE_MICRO, PIPE_SEQ), generator=gen,
                           device="cuda").cpu()
    ref = single_device_logits(cfg, seed, tokens)
    tp = TP_SIZE // PIPE_STAGES
    t0 = time.perf_counter()
    ranks = spmd.run(pipe_rank, TP_SIZE, (cfg, seed, tokens), timeout=600)
    seconds = time.perf_counter() - t0
    v = cfg.vocab_p // tp
    checks = [{"pod": r["pod"], "model": r["model"], **logit_check(
        f"pipeline_forward rank {i} vs single device", r["logits"].cuda(),
        ref[..., r["model"] * v:(r["model"] + 1) * v], TP_LOGIT_BOUNDS)}
        for i, r in enumerate(ranks)]
    launches = [r["launches"] for r in ranks]
    ticks = PIPE_MICRO + PIPE_STAGES - 1
    want = want_counts(PIPE_LAYERS // PIPE_STAGES * ticks)
    emit("pipeline_forward", arch=cfg.name, stages=PIPE_STAGES, tp=tp, layers=PIPE_LAYERS,
         microbatches=PIPE_MICRO, ticks=ticks, tokens=[PIPE_MICRO, PIPE_SEQ],
         dtype=cfg.dtype, backend="gloo", ring=sorted({r["ring"] for r in ranks}),
         flash_shape_per_rank=[1, cfg.heads // tp, cfg.kv_heads // tp, PIPE_SEQ, PIPE_SEQ,
                               cfg.hd],
         launches_per_rank=launches, ms_per_rank=[r["ms"] for r in ranks],
         seconds=seconds, per_rank=checks)
    if any(n != want for n in launches):
        raise AssertionError(f"each rank's pass launched {launches}, expected {want}")
    return launches


def _keyed(tree) -> dict:
    return {"/".join(map(str, path)): t for path, t in tree_flatten_with_path(tree)[0]}


def _sync_s(t0: float) -> float:
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_train() -> dict:
    """qwen3_4b at full width and depth trains for TRAIN_STEPS steps of the
    port's ``make_step_fn`` (bf16, remat off, as the launcher) on the card.
    Checks: every leaf's gradient on the first batch is finite with a
    nonzero norm (a kernel that cut the graph would leave some at zero);
    every loss and gradient norm is finite; the first step's loss is within
    TRAIN_LOSS_BOUND of the kernel path's loss for the same weights and
    batch.  Prints s/step and tokens/s (median of steps 2 on), the peak
    device memory over init and the steps, and each loss."""
    cfg = get_config("qwen3_4b")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = Model(cfg, impl="reference", device="cuda")  # the trainer's path
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    init_s = _sync_s(t0)
    data = SyntheticLM(DataConfig(cfg.vocab, TRAIN_BATCH[1], TRAIN_BATCH[0], seed=SEED))
    batches = [tree_map(lambda t: t.cuda(), data.batch_at(s)) for s in range(TRAIN_STEPS)]
    tcfg = TrainConfig(opt=TRAIN_OPT, remat=False)
    _, grads = local_grads(model, tcfg, params, batches[0])
    norms = {k: float(torch.linalg.vector_norm(g, dtype=torch.float32))
             for k, g in _keyed(grads).items()}
    del grads
    t0 = time.perf_counter()  # the forward and backward alone, warm
    grads = local_grads(model, tcfg, params, batches[0])[1]
    grads_s = _sync_s(t0)
    del grads
    with torch.inference_mode():
        kernel_loss = float(Model(cfg, device="cuda").loss(params, batches[0]))
    opt = adamw_init(params)
    step = make_step_fn(model, tcfg)
    reset_counts()
    losses, gnorms, times = [], [], []
    for i, batch in enumerate(batches):
        if i == len(batches) - 1:  # the last step's own peak, its arguments included
            phase_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        times.append(_sync_s(t0))
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    launches = counts()
    step_peak = torch.cuda.max_memory_allocated() - held
    peak = max(phase_peak, torch.cuda.max_memory_allocated())
    s_step = float(np.median(times[1:]))
    tokens = TRAIN_BATCH[0] * TRAIN_BATCH[1]
    MEASURED["train"] = {"s_per_step": s_step, "forward_backward_s": grads_s,
                         "peak_gib": peak / 2**30, "step_peak_gib": step_peak / 2**30}
    zero = sorted(k for k, n in norms.items() if not (math.isfinite(n) and n > 0))
    emit("train", arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype, impl="reference",
         batch=list(TRAIN_BATCH), steps=TRAIN_STEPS, params_b=sum(
             t.numel() for t in tree_leaves(params)) / 1e9, init_s=init_s,
         s_per_step=s_step, tokens_per_s=tokens / s_step, step_s=times,
         forward_backward_s=grads_s, losses=losses,
         grad_norms=gnorms, kernel_path_loss=kernel_loss,
         first_loss_diff=abs(losses[0] - kernel_loss), loss_bound=TRAIN_LOSS_BOUND,
         grad_leaves=len(norms), zero_or_nonfinite_grad_leaves=zero,
         held_before_init_gib=held / 2**30, peak_gib=peak / 2**30,
         step_peak_gib=step_peak / 2**30, launches=launches)
    del model, params, opt, batches
    torch.cuda.empty_cache()
    if zero:
        raise AssertionError(f"train: leaves without a finite nonzero gradient: {zero}")
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"train: non-finite loss or grad norm: {losses} {gnorms}")
    if not abs(losses[0] - kernel_loss) <= TRAIN_LOSS_BOUND:
        raise AssertionError(f"train: first loss {losses[0]} vs the kernel path's "
                             f"{kernel_loss}, bound {TRAIN_LOSS_BOUND}")
    return launches


def _worst_rel(got, want) -> float:
    """The worst leaf's max abs error over its max abs value."""
    return max(float((a.cpu().double() - b.double()).abs().max())
               / max(float(b.abs().max()), 1e-30)
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


def phase_train_parity() -> dict:
    """One f32 step of qwen3_4b (full width, PARITY_LAYERS layers) on the card
    and on the host's CPU, from the same weights, batch and state, TF32 off:
    the loss, the gradient norm, and every updated parameter and moment
    agree within PARITY_BOUNDS.  The link from the card to the CPU tests,
    which hold the port to JAX."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("qwen3_4b"), n_layers=PARITY_LAYERS,
                              dtype="float32")
    params = Model(cfg, impl="reference", device="cuda").init(
        torch.Generator(device="cuda").manual_seed(SEED + 2))
    host = tree_map(lambda t: t.to("cpu", copy=True), params)
    batch = SyntheticLM(DataConfig(cfg.vocab, PARITY_BATCH[1], PARITY_BATCH[0],
                                   seed=SEED)).batch_at(0)
    tcfg = TrainConfig(opt=TRAIN_OPT, remat=False)
    out, seconds = {}, {}
    for dev, p in (("cuda", params), ("cpu", host)):
        model = Model(cfg, impl="reference", device=dev)
        opt = adamw_init(p)
        reset_counts()
        t0 = time.perf_counter()
        out[dev] = make_step_fn(model, tcfg)(p, opt, tree_map(lambda t: t.to(dev), batch))
        seconds[dev] = _sync_s(t0)
        if dev == "cuda":
            launches = counts()
    (gp, gs, gm), (hp, hs, hm) = out["cuda"], out["cpu"]
    errs = {"loss": abs(float(gm["loss"]) - float(hm["loss"])) / abs(float(hm["loss"])),
            "grad_norm": abs(float(gm["grad_norm"]) - float(hm["grad_norm"]))
            / float(hm["grad_norm"]),
            "params": _worst_rel(gp, hp), "m": _worst_rel(gs["m"], hs["m"]),
            "v": _worst_rel(gs["v"], hs["v"])}
    emit("train_parity", arch=cfg.name, layers=PARITY_LAYERS, dtype=cfg.dtype,
         batch=list(PARITY_BATCH), host=host_cpu(), loss={d: float(m["loss"]) for d, (
             _, _, m) in out.items()}, grad_norm={d: float(m["grad_norm"]) for d, (
                 _, _, m) in out.items()}, rel_err=errs, bounds=PARITY_BOUNDS,
         step_s=seconds, launches=launches)
    del out, params, host, gp, gs
    torch.cuda.empty_cache()
    bad = {k: v for k, v in errs.items() if not v <= PARITY_BOUNDS[k]}
    if bad:
        raise AssertionError(f"train_parity: the card's step differs from the host's: {bad}")
    return launches


def _first_step_errors(r: dict, data_group, dp: int, opt: AdamWConfig, flags,
                       device: str = "cuda") -> dict:
    """The rank's first-step moments and gradient norm against a plain first
    step from every data rank's local gradients (``r["grads"]``), gathered
    over ``data_group`` by torch.distributed's all_gather: their mean, its
    norm, the clip, m = (1 - b1) g and v = (1 - b2) g^2, the rank's slice of
    each ZeRO-1 leaf (``flags``; None: unsharded moments)."""
    grads = tree_leaves(r["grads"])
    means = []
    for g in grads:
        parts = [torch.empty_like(g) for _ in range(dp)]
        torch.distributed.all_gather(parts, g.contiguous(), group=data_group)
        means.append(sum(parts[1:], parts[0]).to(device) / dp)
    norm = math.sqrt(sum(float(torch.sum(torch.square(g.double()))) for g in means))
    clip = min(1.0, opt.grad_clip / max(norm, 1e-12))
    dims = tree_leaves(flags) if flags is not None else [-1] * len(means)
    err = {"m": 0.0, "v": 0.0}
    for g, dim, m, v in zip(means, dims, tree_leaves(r["opt"]["m"]),
                            tree_leaves(r["opt"]["v"])):
        g = g * clip
        if dim >= 0:
            n = g.shape[dim] // dp
            g = g.narrow(dim, r["data"] * n, n)
        for name, got, want in (("m", m, (1 - opt.b1) * g), ("v", v, (1 - opt.b2) * g * g)):
            e = float((got.to(device) - want).abs().max()) / max(float(want.abs().max()), 1e-30)
            err[name] = max(err[name], e)
    err["grad_norm"] = abs(r["metrics"][0]["grad_norm"] - norm) / norm
    return err


def tpdp_train_rank(rank: int, world: int, cfg, seed: int, batch: dict,
                    ref_path: str) -> dict:
    """One rank of the tpdp_train phase (runs in a spawned process): each
    variant's step, its kernel counts read around it, the worst delta of
    the rank's updated shards from the same shards of the single-device
    step (read from ``ref_path``), and its moments' and gradient norm's
    errors from a plain first step (``_first_step_errors``); the SP
    variant's loss, moments and gradient norm also against the plain TP
    step's on this rank (``vs_tp_rel_err``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = torch.load(ref_path, mmap=True)
    dp = world // TPDP_TP
    data_group = make_debug_mesh(TPDP_TP, dp, device_type="cpu").get_group("data")
    flags = _zero_flags_from_specs(ref, dp, param_specs(ref))
    out, tp_step = {}, None
    for variant, (tcfg, sp) in TPDP_TRAIN_VARIANTS.items():
        reset_counts()
        r = spmd.train_step(rank, world, cfg, seed, [batch], TPDP_TP, tcfg, device="cuda",
                            sp=sp, grads=not sp)
        launches = counts()
        want = shard_params(ref, param_specs(ref), r["model"], TPDP_TP)
        worst = max(float((a - b).abs().max())
                    for a, b in zip(tree_leaves(r["params"]), tree_leaves(want)))
        # the SP step is held to the TP step below, which is held to this
        errs = {} if sp else _first_step_errors(r, data_group, dp, tcfg.opt,
                                                flags if tcfg.zero1 else None)
        out[variant] = {"data": r["data"], "model": r["model"], "loss": r["losses"][0],
                        "grad_norm": r["metrics"][0]["grad_norm"], "ms": r["ms"][0],
                        "worst_param_delta": worst, "first_step_rel_err": errs,
                        "launches": launches}
        if variant == "plain":  # the TP step's first loss, norm and moments
            tp_step = (r["losses"][0], r["metrics"][0]["grad_norm"], r["opt"])
        elif sp:
            loss, norm, moments = tp_step
            out[variant]["vs_tp_rel_err"] = {
                "loss": abs(r["losses"][0] - loss) / abs(loss),
                "grad_norm": abs(r["metrics"][0]["grad_norm"] - norm) / norm,
                "m": _worst_rel(r["opt"]["m"], moments["m"]),
                "v": _worst_rel(r["opt"]["v"], moments["v"])}
            tp_step = None
        del r, want
        torch.cuda.empty_cache()
    return out


def phase_tpdp_train() -> dict:
    """One train step of qwen3_4b (full width, PARITY_LAYERS layers, f32) on
    four gloo ranks sharing the card, a (data, model) = (2, TPDP_TP) mesh,
    plain, ZeRO-1 and sequence-parallel, each against the single-device
    step on the card from the same weights and batch, at TPDP_TRAIN_BOUNDS,
    and each rank's moments and gradient norm against a plain first step,
    at TPDP_TRAIN_MOMENT_REL; the SP step's loss, moments and norm also
    against the TP step's on each rank."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("qwen3_4b"), n_layers=PARITY_LAYERS,
                              dtype="float32")
    seed = SEED + 3
    batch = SyntheticLM(DataConfig(cfg.vocab, TPDP_TRAIN_BATCH[1], TPDP_TRAIN_BATCH[0],
                                   seed=SEED)).batch_at(0)
    model = Model(cfg, impl="reference", device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    t0 = time.perf_counter()
    params, _, metrics = make_step_fn(model, TPDP_TRAIN_VARIANTS["plain"][0])(
        params, adamw_init(params), tree_map(lambda t: t.cuda(), batch))
    single_s = _sync_s(t0)
    ref_loss = float(metrics["loss"])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "single_device_step.pt")
        torch.save(tree_map(lambda t: t.cpu(), params), path)
        del model, params, metrics
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = spmd.run(tpdp_train_rank, TP_SIZE, (cfg, seed, batch, path), timeout=900)
        seconds = time.perf_counter() - t0
    launches = {}
    for variant in TPDP_TRAIN_VARIANTS:
        rows = [r[variant] for r in ranks]
        emit("tpdp_train", arch=cfg.name, variant=variant, tp=TPDP_TP,
             dp=TP_SIZE // TPDP_TP, layers=PARITY_LAYERS, dtype=cfg.dtype,
             batch=list(TPDP_TRAIN_BATCH), backend="gloo", single_device_loss=ref_loss,
             single_device_step_s=single_s, bounds=list(TPDP_TRAIN_BOUNDS),
             loss_rel_bound=TPDP_TRAIN_LOSS_REL, moment_rel_bound=TPDP_TRAIN_MOMENT_REL,
             seconds=seconds, per_rank=rows)
        launches[variant] = [r["launches"] for r in rows]
        for r in rows:
            rel = abs(r["loss"] - ref_loss) / abs(ref_loss)
            errs = r["first_step_rel_err"]
            vs_tp = r.get("vs_tp_rel_err", {})
            if not (rel < TPDP_TRAIN_BOUNDS[0] and rel <= TPDP_TRAIN_LOSS_REL
                    and r["worst_param_delta"] < TPDP_TRAIN_BOUNDS[1]
                    and all(e <= TPDP_TRAIN_MOMENT_REL for e in errs.values())
                    and vs_tp.get("loss", 0.0) <= TPDP_TRAIN_LOSS_REL
                    and all(e <= TPDP_TRAIN_MOMENT_REL for k, e in vs_tp.items()
                            if k != "loss")):
                raise AssertionError(f"tpdp_train {variant}: rank ({r['data']}, "
                                     f"{r['model']}) loss {r['loss']} vs {ref_loss}, "
                                     f"worst param delta {r['worst_param_delta']}, "
                                     f"first-step errors {errs}, against TP {vs_tp}")
    return launches


def _launch(argv: list) -> tuple[int, list, float]:
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        code = launch_train.main(argv)
    return code, buf.getvalue().splitlines(), time.perf_counter() - t0


def phase_train_launcher() -> None:
    """The training launcher on the card at SMOKE size, tp 2 x dp 2 gloo ranks
    sharing it: the verification gate passes and the loss falls by more
    than 0.3 in 40 steps (the JAX reference's
    test_train_verify_gate_and_loss_decreases); 20 steps with checkpoints,
    then a resume to 30 from step 20; ``--zero1 --dp 2`` exits 2 before
    training; ``--sp`` (the gate proves the sequence-parallel plan, then the
    ranks train with SP on the card) trains 6 steps and its loss falls."""
    smoke = ["--arch", "qwen3_4b", "--smoke", "--tp", "2", "--dp", "2", "--device", "cuda"]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = ["--ckpt-dir", tmp, "--ckpt-every", "10", "--skip-verify"]
        runs = [("learn", [*smoke, "--steps", "40", "--seq", "64", "--batch", "8",
                           "--lr", "3e-3"], 0),
                ("checkpoint", [*smoke, "--steps", "20", *ckpt], 0),
                ("resume", [*smoke, "--steps", "30", "--resume", *ckpt], 0),
                ("sp", [*smoke, "--sp", "--steps", "6", "--seq", "64", "--batch", "8"], 0),
                ("zero1", ["--arch", "qwen3_4b", "--smoke", "--zero1", "--dp", "2",
                           "--device", "cuda"], 2)]
        for name, argv, want in runs:
            code, out, seconds = _launch(argv)
            losses = [float(m) for m in re.findall(r"loss (\d+\.\d+)", "\n".join(out))]
            emit("train_launcher", run=name, argv=argv, exit=code, seconds=seconds,
                 losses=losses, out=out)
            ok = code == want
            if name == "learn":
                ok &= (any(line.startswith("[verify] VERIFIED") for line in out)
                       and len(losses) > 1 and losses[0] - losses[-1] > 0.3)
            elif name == "checkpoint":
                ok &= "[ckpt] saved step 20" in out
            elif name == "sp":
                ok &= (any(line.startswith("[verify] checking") and "+sp" in line
                           for line in out)
                       and any(line.startswith("[verify] VERIFIED") for line in out)
                       and "[done] 6 steps" in "\n".join(out) and len(losses) > 1
                       and losses[-1] < losses[0])
            elif name == "resume":
                ok &= (any(line.startswith("[ckpt] resumed") and line.endswith("at step 20")
                           for line in out) and "[done] 10 steps" in "\n".join(out))
            else:
                ok &= bool(out) and "REFUSED" in out[0] and not losses
            if not ok:
                raise AssertionError(f"train_launcher {name}: exit {code}: {out}")


def phase_serve_verified() -> None:
    """The serving launcher with its decode-plan pre-flight on the card:
    ``--verify-tp 2`` for qwen3_4b proves the plan, then serves; ``--verify-tp
    4`` is an invalid plan for its SMOKE config (2 KV heads), as in the JAX
    launcher, and must exit 2 before serving."""
    for tp, want in ((2, 0), (4, 2)):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            code = launch_serve.main(["--arch", "qwen3_4b", "--verify-tp", str(tp),
                                      "--device", "cuda"])
        out = buf.getvalue().splitlines()
        verify = [line for line in out if line.startswith("[verify]")]
        stats = [line for line in out if line.startswith("[stats]")]
        emit("serve_verified", arch="qwen3_4b SMOKE", verify_tp=tp, exit=code,
             verify=verify, served=sum(line.startswith("[done]") for line in out),
             stats=stats, seconds=time.perf_counter() - t0)
        if code != want:
            raise AssertionError(f"--verify-tp {tp} exited {code}, expected {want}")
        if want == 0 and not (any(line.startswith("[verify] VERIFIED") for line in verify)
                              and stats and stats[0].endswith("on cuda")):
            raise AssertionError(f"--verify-tp {tp}: not verified, or not served on the "
                                 f"card: {out}")
        if want == 2 and (stats or not any("ABORTING" in line for line in verify)):
            raise AssertionError(f"--verify-tp {tp}: served an invalid plan: {out}")


def phase_serve_encoder() -> None:
    """The serving launcher refuses an encoder-only arch with exit 1, as the
    JAX launcher does, before it draws any weight."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = launch_serve.main(["--arch", "hubert_xlarge", "--device", "cuda"])
    out = buf.getvalue().splitlines()
    emit("serve", arch="hubert_xlarge", exit=code, out=out)
    if code != 1 or out != ["hubert_xlarge is encoder-only: no decode serving"]:
        raise AssertionError(f"hubert_xlarge: the launcher exited {code}: {out}")


def emit_memory(arch: str, held: int, params) -> None:
    """The device memory of one model's init and prefill: what was held
    before the init, the parameters, and the peak since the last
    ``reset_peak_memory_stats`` (taken just before the init)."""
    emit("device memory", arch=arch, held_before_init_gib=held / 2**30,
         params_gib=nbytes(*_leaves(params)) / 2**30,
         peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# The lint tier on the card's host: dense archs at full width with
# LINT_LAYERS layers, one device and tp 4, and sequence-parallel at tp 4
# (all seven dense archs took 17.7 s on an H100 machine's host, in a run of
# 999 s; cut to four, gemma_2b's GeGLU and chatglm3_6b's padded KV heads
# among them; tests/test_torch_lint.py lints six at every degree).
LINT_ARCHS = ("llama3_8b", "qwen3_4b", "chatglm3_6b", "gemma_2b")
LINT_LAYERS = 2
# The dry run's cells, one of each kind, on the 16x16 production mesh at full
# depth (the reference's flags).
DRYRUN_CELLS = (("qwen3_4b", "train_4k", {}), ("llama3_8b", "prefill_32k", {}),
                ("llama3_405b", "decode_32k", {"gather_weights": True}))
# What the train and prefill phases measured, for the roofline phase.
MEASURED: dict = {}
# The train step's estimated peak (dryrun.memory_estimate: MemTracker over a
# fake run, the arguments included, each storage once) over the peak the
# allocator reads over the train phase's last step (its arguments included):
# 3x the first card reading's |log ratio| on either side, 64.85 / 63.39 GiB =
# 1.0229 (H100 80GB HBM3, 700 W): a peak that left out or doubled the f32
# moments (0.55x or 1.5x) fails.
PEAK_EST_RATIO = (0.93, 1.07)


def phase_lint() -> None:
    """The port's lint tier (``repro_torch.analysis``) on single traced
    graphs: each of LINT_ARCHS lints with no error and no warning at tp 1,
    at tp 4 and sequence-parallel at tp 4; llama3_8b's tp-4 graph with its
    first layer's all_reduce dropped is flagged, the top finding a
    missing_all_reduce at a line of the model code; the rule registry's
    static check (``rulecheck``) is clean.  Host seconds."""
    from repro_torch.analysis import check_registry, run_lints, trace_lint_unit, unit_context
    from repro_torch.core.inject import DEFAULT_INJECTORS

    failed = []
    for arch in LINT_ARCHS:
        for tp, sp in ((1, False), (TP_SIZE, False), (TP_SIZE, True)):
            t0 = time.perf_counter()
            unit = trace_lint_unit(arch, tp, sp=sp, layers=LINT_LAYERS)
            rep = run_lints(unit_context(unit))
            emit("lint", arch=arch, tp=tp, sp=sp, layers=LINT_LAYERS, ok=rep.ok,
                 errors=rep.errors, warnings=rep.warnings, passes=len(rep.passes),
                 nodes=len(unit.graph.nodes), seconds=time.perf_counter() - t0)
            if not rep.ok or rep.errors or rep.warnings:
                failed.append(f"{arch} tp {tp} sp {sp}: {rep.summary()}")
    unit = trace_lint_unit("llama3_8b", TP_SIZE, layers=LINT_LAYERS)
    inj = DEFAULT_INJECTORS.get("drop_all_reduce")(unit.graph, index=1)
    rep = run_lints(unit_context(unit.mutate(lambda g: inj.graph)))
    top = rep.findings[0] if rep.findings else None
    localized = (top is not None and top.category == "missing_all_reduce"
                 and re.fullmatch(r"(model|attention|mlp|modules)\.py:\d+", top.src or ""))
    emit("lint", arch="llama3_8b", tp=TP_SIZE, inject="drop_all_reduce", site=inj.site,
         ok=rep.ok, findings=[{"pass": f.pass_name, "category": f.category, "op": f.op,
                               "src": f.src} for f in rep.findings[:3]],
         localized=bool(localized))
    if rep.ok or not localized:
        failed.append(f"drop_all_reduce on llama3_8b tp {TP_SIZE}: {rep.summary()}")
    rc = check_registry()
    emit("lint", rulecheck_ok=rc.ok, rules=rc.num_rules, ops=rc.num_ops,
         dead_rules=rc.dead_rules, orphan_kinds=rc.orphan_kinds, drift=rc.drift)
    if not rc.ok:
        failed.append(rc.summary())
    if failed:
        raise AssertionError(f"lint phase: {failed}")


def phase_dryrun(card: str) -> None:
    """The dry run on the card's host: each of DRYRUN_CELLS traced under a
    fake process group over the 16x16 mesh with fake tensors, at full
    depth.  Per device: memory, the roofline terms under the H100 model, the
    dominant term and the useful-FLOP ratio.  Checks: every cell ends ok,
    no device memory is taken, and the train cell's useful-FLOP ratio is at
    most 1 (with remat the IR counts more than 6·N·D: a ratio above 1 means
    a loop's multiplicity was lost)."""
    # run by host_phases in a process that has not touched the card: it must
    # not start to (or, run alone after the card is in use, take memory)
    touched = torch.cuda.is_initialized()
    held = torch.cuda.memory_allocated() if touched else 0
    failed = []
    for arch, shape, kw in DRYRUN_CELLS:
        res = dryrun.run_cell(arch, shape, **kw)
        roof = res.get("roofline", {})
        emit("dryrun", arch=arch, shape=shape, mesh=res["mesh"], flags=kw,
             status=res["status"], memory=res.get("memory"),
             **{k: roof.get(k) for k in ("compute_s", "memory_s", "memory_s_pallas",
                                         "collective_s", "dominant", "useful_flop_ratio",
                                         "roofline_fraction_pallas")},
             ir=res.get("ir"), collective_wire_bytes=res.get("collective_wire_bytes"),
             trace_s=res.get("trace_s"), memory_est_s=res.get("memory_s"),
             seconds=res["wall_s"], error=res.get("error"), card=card)
        if res["status"] != "ok":
            failed.append(f"{arch} {shape}: {res.get('error')}")
        elif SHAPES[shape].kind == "train" and not roof["useful_flop_ratio"] <= 1:
            failed.append(f"{arch} {shape}: useful_flop_ratio {roof['useful_flop_ratio']}")
    if torch.cuda.is_initialized() != touched or (
            touched and torch.cuda.memory_allocated() != held):
        failed.append("the dry run used the card")
    if failed:
        raise AssertionError(f"dryrun phase: {failed}")


def phase_roofline(card: str) -> None:
    """The H100 roofline held to the card: the port's ``collect_ir_stats``
    and ``roofline_terms`` on two one-device programs the earlier phases
    timed, the forward and backward of qwen3_4b's train step
    (``local_grads``: bf16, batch TRAIN_BATCH, the reference path, remat
    off, as the train phase times it; the in-place AdamW after it adds no
    materialized op to the bound) and its prefill of (2, 1024) through K1
    (the memory term with the kernels' regions on chip).  Each measured
    time must be at least its roofline bound.  Prints model_flops /
    PEAK_FLOPS / measured, and the whole step's estimated peak memory
    (``dryrun.memory_estimate``) against the peak of the train phase's last
    step, within PEAK_EST_RATIO."""
    cfg = get_config("qwen3_4b")
    model = Model(cfg, impl="reference", device="cpu")
    params = model.param_shapes()
    failed = []
    B, S = TRAIN_BATCH
    tcfg = TrainConfig(opt=TRAIN_OPT, remat=False)
    batch = input_specs(cfg, ShapeSpec("train", S, B, "train"))
    opt = {"m": dryrun._f32_like(params), "v": dryrun._f32_like(params),
           "step": ShapeDtype((), torch.int32)}
    t0 = time.perf_counter()
    ir = analysis.collect_ir_stats(step_phases(model, tcfg)[0], (params, batch), {},
                                   grad=True)
    trace_s = time.perf_counter() - t0
    mf = 6.0 * cfg.active_param_count() * B * S
    roof = analysis.roofline_terms(ir, model_flops_per_device=mf)
    t0 = time.perf_counter()
    est = dryrun.memory_estimate(make_step_fn(model, tcfg), (params, opt, batch), grad=True)
    measured = MEASURED["train"]
    fb_s = measured["forward_backward_s"]
    emit("roofline", program="qwen3_4b train step's forward and backward",
         batch=list(TRAIN_BATCH), measured_s=fb_s, bound_s=roof["bound_s"],
         measured_over_bound=fb_s / roof["bound_s"], step_s=measured["s_per_step"],
         **{k: roof[k] for k in ("compute_s", "memory_s", "collective_s", "dominant",
                                 "useful_flop_ratio")},
         ir_dot_flops=ir["ir_dot_flops"], ir_ew_flops=ir["ir_ew_flops"],
         ir_hbm_bytes=ir["ir_hbm_bytes"], model_flops=mf,
         model_flops_fraction=mf / analysis.PEAK_FLOPS / fb_s,
         estimated_peak_gib=(est["peak_bytes"] / 2**30 if est["peak_bytes"] else None),
         measured_step_peak_gib=measured["step_peak_gib"],
         estimated_over_measured=(est["peak_bytes"] / 2**30 / measured["step_peak_gib"]
                                  if est["peak_bytes"] else None),
         peak_bound=PEAK_EST_RATIO, peak_note=est.get("peak_note"),
         trace_s=trace_s, memory_est_s=time.perf_counter() - t0, card=card)
    if not fb_s >= roof["bound_s"] > 0:
        failed.append(f"train step's forward and backward {fb_s} s under its bound "
                      f"{roof['bound_s']} s")
    if est["peak_bytes"] is None or not (
            PEAK_EST_RATIO[0] <= est["peak_bytes"] / 2**30 / measured["step_peak_gib"]
            <= PEAK_EST_RATIO[1]):
        failed.append(f"train step's estimated peak {est['peak_bytes']} B against "
                      f"{measured['step_peak_gib']} GiB measured, bound {PEAK_EST_RATIO}: "
                      f"{est.get('peak_note')}")
    shape = (2, 1024)
    batch = input_specs(cfg, ShapeSpec("prefill", shape[1], shape[0], "prefill"))
    t0 = time.perf_counter()
    ir = analysis.collect_ir_stats(lambda p, b: model.forward(p, b), (params, batch), {})
    mf = 2.0 * cfg.active_param_count() * shape[0] * shape[1]
    roof = analysis.roofline_terms(ir, model_flops_per_device=mf)
    measured_s = MEASURED[f"prefill {cfg.name}"]
    emit("roofline", program="qwen3_4b prefill through K1", batch=list(shape),
         measured_s=measured_s, bound_s=roof["bound_s_pallas"],
         measured_over_bound=measured_s / roof["bound_s_pallas"],
         **{k: roof[k] for k in ("compute_s", "memory_s", "memory_s_pallas",
                                 "collective_s", "dominant", "useful_flop_ratio")},
         ir_dot_flops=ir["ir_dot_flops"], ir_ew_flops=ir["ir_ew_flops"],
         ir_hbm_bytes=ir["ir_hbm_bytes"], ir_kernel_saved_bytes=ir["ir_kernel_saved_bytes"],
         model_flops=mf, model_flops_fraction=mf / analysis.PEAK_FLOPS / measured_s,
         trace_s=time.perf_counter() - t0, card=card)
    if not measured_s >= roof["bound_s_pallas"] > 0:
        failed.append(f"prefill {measured_s} s under its bound {roof['bound_s_pallas']} s")
    if failed:
        raise AssertionError(f"roofline phase: {failed}")


def run_host_phases(card: str) -> None:
    """The phases that run on the host only (lint, dryrun), in the child
    process ``host_phases`` starts."""
    phase_lint()
    phase_dryrun(card)


@contextlib.contextmanager
def host_phases(card: str):
    """The host-only phases in a child process, which runs while the kernel
    phases time the card (those time on the device, with CUDA events);
    ``finish`` prints its lines and raises if it failed.  The child is
    killed if the caller fails first."""
    proc = subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.run_host_phases({card!r})"],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)

    def finish() -> None:
        out, _ = proc.communicate(timeout=900)
        sys.stdout.write(out)
        sys.stdout.flush()
        if proc.returncode:
            raise AssertionError(f"host phases (lint, dryrun) exit {proc.returncode}: "
                                 f"{out[-2000:]}")
    try:
        yield finish
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def _roofline_alone(gen, card: str) -> None:
    """The roofline phase with the two phases whose times it reads: the
    train phase and qwen3_4b's prefill of (2, 1024)."""
    phase_train()
    with torch.inference_mode():
        cfg = get_config("qwen3_4b")
        model = Model(cfg, device="cuda")
        phase_prefill(cfg, model, model.init(gen), gen, (2, 1024))
        del model
    torch.cuda.empty_cache()
    phase_roofline(card)


def run_alone(name: str) -> None:
    """Build the kernels and run one phase on its own (a planted fault's
    check of the phase that should catch it); raises if it fails."""
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    card = card_name()
    phases = {
        "dp_forward": lambda: phase_dp_forward(gen),
        "tp_forward": lambda: phase_tp_forward(gen),
        "sp_forward": lambda: phase_sp_forward(gen),
        "tp_decode": lambda: phase_tp_decode(gen),
        "cp_decode": lambda: phase_cp_decode(gen),
        "dp_grad_run": lambda: phase_dp_grad_run(gen),
        "tpdp_forward": lambda: phase_tpdp_forward(gen),
        "pipeline_forward": lambda: phase_pipeline_forward(gen),
        "verify": lambda: phase_verify(card),
        "dp_grad_verify": lambda: phase_dp_grad_verify(card),
        "dryrun": lambda: phase_dryrun(card),
        "roofline": lambda: _roofline_alone(gen, card),
        "campaign": phase_campaign,
        "lint": phase_lint,
        "train": phase_train,
        "train_parity": phase_train_parity,
        "tpdp_train": phase_tpdp_train,
        "train_launcher": phase_train_launcher,
        "serve_verified": phase_serve_verified,
    }
    phases[name]()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_run = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    gen_ssm = torch.Generator(device="cuda").manual_seed(SEED + 1)  # the SSM phases'
    card = card_name()
    # the lint tier and the dry run run on the host, beside the kernel phases
    with host_phases(card) as finish_host_phases:
        with torch.inference_mode():
            phase_device()
            phase_resources()
            fa_rows = phase_flash(gen)
            rn_row = phase_rmsnorm(gen)["qwen3_4b"]
            ssd_rows = phase_ssd(gen_ssm)
            conv_rows = phase_causal_conv(gen_ssm)
            sgn_rows = phase_skip_gated_norm(gen_ssm)
        finish_host_phases()
    # training runs with grad enabled, outside inference_mode
    train_launches = phase_train()
    parity_launches = phase_train_parity()
    tpdp_train_launches = phase_tpdp_train()
    phase_train_launcher()
    with torch.inference_mode():
        cfg = get_config("qwen3_4b")
        model = Model(cfg, device="cuda")
        params = model.init(gen)
        launches = phase_prefill(cfg, model, params, gen, (2, 1024))
        phase_serve(cfg, model, params)
        del model, params
        torch.cuda.empty_cache()
    phase_roofline(card)  # the train step's and this prefill's times against the model
    with torch.inference_mode():
        dense_launches = {}
        for arch in ("qwen1_5_4b", "chatglm3_6b", "gemma_2b"):
            cfg = get_config(arch)
            model = Model(cfg, device="cuda")
            params = model.init(gen)
            if arch == "gemma_2b" and ("lm_head" in params or cfg.mlp_act != "geglu"
                                       or "wg" not in params["blocks"][0]["mlp"]):
                raise AssertionError("gemma_2b: expected a tied head and a GeGLU MLP")
            dense_launches[arch] = phase_prefill(cfg, model, params, gen, (2, 1024))
            phase_serve(cfg, model, params)
            del model, params
            torch.cuda.empty_cache()
        cfg = get_config("mamba2_130m")
        model = Model(cfg, device="cuda")
        params = init_mamba2(model, gen_ssm)
        ssm_launches = phase_prefill(cfg, model, params, gen_ssm, (4, 4096),
                                     SSM_LOGIT_BOUNDS)
        phase_serve(cfg, model, params, check_len=256, bounds=SSM_LOGIT_BOUNDS)
        del model, params
        torch.cuda.empty_cache()
        # the frontends: hubert_xlarge (prefill only; the launcher refuses
        # the encoder) and internvl2_26b (about 41 GB of bf16 weights)
        frontend_launches = {}
        for arch in ("hubert_xlarge", "internvl2_26b"):
            cfg = get_config(arch)
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            model = Model(cfg, device="cuda")
            params = model.init(gen)
            bounds = VLM_LOGIT_BOUNDS if cfg.frontend == "vision_patches" else (
                LOGIT_REL_RMS, LOGIT_MAX_ABS)
            frontend_launches[arch] = phase_prefill(cfg, model, params, gen, (2, 1024),
                                                    bounds)
            emit_memory(arch, held, params)
            if cfg.encoder_only:
                phase_serve_encoder()
            else:
                phase_serve(cfg, model, params, bounds=bounds)
            del model, params
            torch.cuda.empty_cache()
        # the MoE archs: granite_moe_3b at full width and depth (prefill,
        # its dispatch against the plain loop, serve), mixtral_8x7b cut to
        # MIXTRAL_LAYERS layers (prefill and dispatch)
        moe_launches = {}
        for arch, layers in (("granite_moe_3b", None), ("mixtral_8x7b", MIXTRAL_LAYERS)):
            cfg = get_config(arch)
            cfg = dataclasses.replace(cfg, n_layers=layers or cfg.n_layers)
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            model = Model(cfg, device="cuda")
            params = model.init(gen)
            moe_launches[arch] = phase_prefill(cfg, model, params, gen, (2, 1024),
                                               MOE_BOUNDS[arch])
            emit_memory(cfg.name, held, params)
            phase_moe_dispatch(cfg, params, gen, (2, 1024))
            if layers is None:
                phase_serve(cfg, model, params)
            del model, params
            torch.cuda.empty_cache()
        # moonshot_v1_16b at full width and depth: 53.8 GiB of bf16 weights,
        # its expert stacks drawn a block at a time (models/modules.py)
        cfg = get_config("moonshot_v1_16b")
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        model = Model(cfg, device="cuda")
        params = model.init(gen)
        moe_launches[cfg.name] = phase_prefill(cfg, model, params, gen, (2, 1024),
                                               MOE_BOUNDS[cfg.name])
        emit_memory(cfg.name, held, params)
        del model, params
        torch.cuda.empty_cache()
    phase_verify(card)
    phase_campaign()
    phase_dp_grad_verify(card)
    dp_grad_launches = phase_dp_grad_run(gen)
    dp_launches = phase_dp_forward(gen)
    tp_launches, sp_launches = phase_tp_forward(gen, sp=True)
    moe_tp_launches, _ = phase_tp_forward(gen, "granite_moe_3b", MOE_TP_LAYERS,
                                          MOE_BOUNDS["tp"])
    decode_launches = phase_tp_decode(gen)
    cp_launches = phase_cp_decode(gen)
    tpdp_launches = phase_tpdp_forward(gen)
    pipe_launches = phase_pipeline_forward(gen)
    phase_serve_verified()
    paths = {"qwen3_4b prefill": launches,
             **{f"{arch} prefill": n for arch, n in dense_launches.items()},
             "mamba2_130m prefill": ssm_launches,
             **{f"{arch} prefill": n for arch, n in frontend_launches.items()},
             "granite_moe_3b prefill": moe_launches["granite_moe_3b"],
             f"mixtral_8x7b prefill ({MIXTRAL_LAYERS} layers)": moe_launches["mixtral_8x7b"],
             "moonshot_v1_16b prefill": moe_launches["moonshot_v1_16b"],
             "dp_forward, each rank": dp_launches,
             "tp_forward, each rank": tp_launches,
             "sp_forward, each rank": sp_launches,
             "tp_forward granite_moe_3b, each rank": moe_tp_launches,
             "tp_decode, each rank": decode_launches,
             "cp_decode, each rank": cp_launches,
             "dp_grad, each rank": dp_grad_launches,
             "tpdp_forward, each rank": tpdp_launches,
             "pipeline_forward, each rank": pipe_launches,
             "train qwen3_4b": train_launches,
             f"train_parity ({PARITY_LAYERS} layers, the card's step)": parity_launches,
             **{f"tpdp_train {v}, each rank": n for v, n in tpdp_train_launches.items()}}
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:70",
         "launches": launches["flash_attention"], **fa_rows["qwen3_4b"],
         **{f"{name}_shape": row for name, row in fa_rows.items() if name != "qwen3_4b"}},
        {"name": "rmsnorm", "route": "triton",
         "source": "src/repro_torch/kernels/rmsnorm.py",
         "replaces": "src/repro/kernels/rmsnorm.py:22",
         "launches": launches["rmsnorm"], **rn_row},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:65",
         "launches": ssm_launches["ssd_scan"], **ssd_rows["mamba2_130m"],
         **{f"{name}_shape": row for name, row in ssd_rows.items() if name != "mamba2_130m"}},
        {"name": "causal_conv", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/causal_conv.cu",
         "replaces": "none (the JAX package leaves the conv to XLA)",
         "launches": ssm_launches["causal_conv"], **conv_rows["mamba2_130m"],
         **{f"{name}_shape": row for name, row in conv_rows.items() if name != "mamba2_130m"}},
        {"name": "skip_gated_norm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/skip_gated_norm.cu",
         "replaces": "none (the JAX package leaves the skip and the gated norm to XLA)",
         "launches": ssm_launches["skip_gated_norm"], **sgn_rows["mamba2_130m"],
         **{f"{name}_shape": row for name, row in sgn_rows.items() if name != "mamba2_130m"}},
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    for row in kernels:  # every main path's count, read around that path
        row["launches_by_path"] = {path: [c[row["name"]] for c in n] if isinstance(n, list)
                                   else n[row["name"]] for path, n in paths.items()}
    extra = ("launches_by_path", *(f"{name}_shape" for name in fa_rows if name != "qwen3_4b"),
             *(f"{name}_shape" for name in ssd_rows if name != "mamba2_130m"),
             *(f"{name}_shape" for name in conv_rows if name != "mamba2_130m"),
             *(f"{name}_shape" for name in sgn_rows if name != "mamba2_130m"))
    emit("run", seconds=time.perf_counter() - t_run, card=card)
    print(json.dumps({"kernels": [{k: row[k] for k in keys + extra if k in row}
                                  for row in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
