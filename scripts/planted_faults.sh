#!/usr/bin/env bash
# Run the checks in throwaway copies of the tree, each with one fault
# planted in a kernel source or in the TP program, and print each run's exit
# code and the lines of the phase that should catch it: the card tests of
# the kernels (python -m pytest -q -m card tests/test_torch_card_kernels.py)
# for a fault in a kernel source, chip_smoke.py for any other.  A sound check
# fails every copy.  Needs one H100, like chip_smoke.py.
#
#   bash scripts/planted_faults.sh [OUT_DIR [FAULT ...]]
#                           # full logs: OUT_DIR/fault_*.txt; default: every fault
#
# Faults in csrc/flash_attention.cu (K1), caught by the card tests:
#   fa_diagonal_unmasked  the causal mask is not applied (only keys past Sk
#                         are masked), so the diagonal tiles see future keys
#   fa_last_kv_stale      the producer fills the last KV stage of each q-tile
#                         with the previous tile's keys: the last K tile is
#                         dropped
#   fa_d256_last_q_box    at head dim 256 the last 64-column box of each Q
#                         tile is never loaded: the producer fills it with
#                         the third box's columns
#   fa_d256_second_consumer_rows  at head dim 256 the second consumer
#                         warpgroup stores its O rows at the first one's
#                         rows of the q-tile, and its own stay unwritten
#   fa_d80_box_extent     at head dim 80 the tensor maps' inner extent is
#                         one box, 64 columns: the second box reads zeros in
#                         place of columns 64-79 of Q, K and V, and the
#                         store leaves O's columns 64-79 unwritten
# Faults in csrc/ssd_scan.cu (K3), caught by the card tests:
#   ssd_carry_dropped     the incoming state's contribution to y (y_off) is
#                         dropped after the first chunk
#   ssd_state_not_decayed the carried state is not decayed by exp(cum_Q)
#   ssd_slice_offset      every P-slice block reads and writes the first
#                         slice's columns
# Faults in csrc/skip_gated_norm.cu (the Mamba-2 mixer's skip and gated
# norm), caught by the card tests:
#   sgn_skip_dropped      the D * x term is left out of the skip
#   sgn_group_offset      each unit reads the next group's sum of squares
#                         (a row of one group reads its own)
#   sgn_fma_contracted    the skip is one fmaf(D, x, y), not a rounded
#                         product and a rounded sum; caught where the rows
#                         hold the kernel bit for bit to the plain arithmetic
#                         given its own rstd
# Faults in the TP program (caught by the verify phase, and the tp_forward
# phase, run on its own after chip_smoke.py, fails its logit check):
#   tp_attn_psum_dropped  the psum after attention's output projection is
#                         removed (models/attention.py)
#   tp_vp_embed_shifted   vp_embed's offset is (rank + 1) * V_loc
#                         (parallel/collectives.py)
# Faults in the serving step and in sequence parallelism:
#   decode_cache_head_offset  under TP a rank writes its new K one head over
#                         (its heads rolled by one) in the KV cache
#                         (models/attention.py); caught by the verify phase,
#                         and by the tp_decode phase, run on its own after
#                         chip_smoke.py
#   sp_gather_wrong_dim   sp_exit gathers along the hidden dim, then
#                         reshapes to the sequence-gathered shape
#                         (parallel/ctx.py); SP runs on the card, so the
#                         tpdp_train phase's SP step fails it first, then
#                         the sp_forward and verify phases, each run on its
#                         own after chip_smoke.py
# A fault in the data-parallel program (caught by the dp_forward phase):
#   dp_rank_rows_swapped  each rank runs the forward on the other rank's
#                         rows of the batch (parallel/spmd.py)
# A fault in the frontends' entry into SP (caught by the verify phase; no
# frontend runs SP on the card):
#   sp_frontend_prev_chunk  each rank takes rank r - 1's chunk of the
#                         replicated frames or prefix (models/model.py)
# Faults in the MoE layers (models/mlp.py):
#   moe_shared_psum_dropped  the shared expert's partial sum is not reduced
#                         in the TP verification formulation (moe_dense_fwd):
#                         the reference's own bug; the verify phase must find
#                         moonshot_v1_16b's tp-forward unverified at mlp.py
#   moe_dispatch_pos_off_by_one  the capacity dispatch counts positions from
#                         1 (pos without - 1), so each full expert drops one
#                         pair too many; the moe dispatch phase (granite's
#                         dispatch against the plain per-expert loop) must
#                         fail
# Faults in the two-axis programs (parallel/):
#   pipeline_ring_stalled  at tick 1 each stage keeps its own activation
#                         (s -> s) instead of receiving stage s - 1's
#                         (parallel/pipeline.py); the pipeline_forward phase
#                         must fail
#   tpdp_psum_on_data_group  a mesh context's model-axis psum runs on the
#                         data axis' group (parallel/ctx.py); the verify
#                         phase must find the composite's tpdp-forward row
#                         unverified, and the tpdp_forward phase, run on its
#                         own after chip_smoke.py, fails its logit check
# Faults in training:
#   train_kernel_path_unguarded  the train phase trains on impl="kernel"
#                         (chip_smoke.py) and the kernels' refusal of
#                         autograd is removed (kernels/ops.py): K1 cuts the
#                         graph, so the train phase's every-leaf gradient
#                         check must fail (wq, wk, wv, qnorm, knorm at zero)
#   loss_label_psum_dropped  Model.loss takes each rank's own part of the
#                         label logit, without its psum over the model axis
#                         (models/model.py); the tpdp_train phase must fail
#   dp_grad_psum_dropped  the train step skips the data-axis all-reduce of
#                         the gradients (train/trainer.py): each rank
#                         updates from its own rows' gradients; tpdp_train's
#                         first-step moment check must fail
#   dp_grad_mean_undivided  the all-reduced gradients are not divided by the
#                         data axis' size (train/trainer.py): the gradient
#                         norm doubles; tpdp_train's first-step check must
#                         fail
# Faults in the gradient-sync program and in context-parallel decode:
#   dp_grad_psum_dropped_rank  spmd.dp_grad returns each rank's gradients
#                         without their psum over the data axis
#                         (parallel/spmd.py): the dp_grad phase's verify
#                         part must find the pair unverified, and its run
#                         part, run on its own after chip_smoke.py, must
#                         fail the full-batch gradient check
#   cp_merge_uncorrected  the flash-decode merge takes every shard's partial
#                         softmax without rescaling it to the global max
#                         (corr = 1, models/attention.py); the cp_decode
#                         phase must fail
# Faults in the lint tier, the roofline and the dry run:
#   lint_pass_disabled    the partial-leak lint pass finds nothing
#                         (analysis/lints.py): the lint phase must fail (the
#                         dropped all_reduce goes unflagged), and the
#                         campaign phase, run on its own after
#                         chip_smoke.py, finds lint_detected unlike the
#                         reference's
#   roofline_peak_div100  the H100 model's bf16 peak is divided by 100
#                         (launch/analysis.py): the train step's compute
#                         bound passes its measured time, so the roofline
#                         phase must fail
#   dryrun_micro_mult_dropped  ops in the microbatch loop lose its trip
#                         count in count mode (scope.py): the train cell's
#                         IR FLOPs fall 8x, its useful-FLOP ratio passes 1,
#                         so the dryrun phase must fail
set -u
root=$(cd "$(dirname "$0")/.." && pwd)
out=${1:-$root/chiprun_out}
shift $(( $# > 0 ? 1 : 0 ))
faults=${*:-fa_diagonal_unmasked fa_last_kv_stale fa_d256_last_q_box \
fa_d256_second_consumer_rows fa_d80_box_extent \
ssd_carry_dropped ssd_state_not_decayed ssd_slice_offset sgn_skip_dropped sgn_group_offset \
sgn_fma_contracted tp_attn_psum_dropped \
tp_vp_embed_shifted decode_cache_head_offset sp_gather_wrong_dim dp_rank_rows_swapped \
sp_frontend_prev_chunk moe_shared_psum_dropped moe_dispatch_pos_off_by_one \
pipeline_ring_stalled tpdp_psum_on_data_group train_kernel_path_unguarded \
loss_label_psum_dropped dp_grad_psum_dropped dp_grad_mean_undivided \
dp_grad_psum_dropped_rank cp_merge_uncorrected lint_pass_disabled roofline_peak_div100 \
dryrun_micro_mult_dropped}
work=$(mktemp -d)
trap 'rm -rf "$work"' EXIT
mkdir -p "$out"
csrc=kernels/csrc
for name in $faults; do
  alone= file2=  # file2: a second edit, old2 -> new2, relative to the tree's root
  case $name in
    fa_diagonal_unmasked)
      file=$csrc/flash_attention.cu phase=card
      old='if (kpos >= Sk || (causal && qpos[(i >> 1) & 1] < kpos)) s[i] = kNeg;'
      new='if (kpos >= Sk) s[i] = kNeg;' ;;
    fa_last_kv_stale)
      file=$csrc/flash_attention.cu phase=card
      old='j * T::BK, bkv);
          mbar_wait(v_empty(s), parity);'
      new='(j - (j > 0 && j == n_kv - 1)) * T::BK, bkv);
          mbar_wait(v_empty(s), parity);' ;;
    fa_d256_last_q_box)
      file=$csrc/flash_attention.cu phase=card
      old='tma_load_3d(sq + b * T::Q_BOX, &qmap, q_full, b * T::BOX, q0, bh);'
      new='tma_load_3d(sq + b * T::Q_BOX, &qmap, q_full, (b - (D == 256 && b == T::NBOX - 1)) * T::BOX, q0, bh);' ;;
    fa_d256_second_consumer_rows)
      file=$csrc/flash_attention.cu phase=card
      old='out + ((size_t)bh * Sq + qpos[h]) * D) + t;'
      new='out + ((size_t)bh * Sq + qpos[h] - 64 * w) * D) + t;' ;;
    fa_d80_box_extent)
      file=$csrc/flash_attention.cu phase=card
      old='const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};'
      new='const cuuint64_t dims[3] = {(cuuint64_t)(D == 80 ? box_cols : D), (cuuint64_t)S, (cuuint64_t)BH};' ;;
    ssd_carry_dropped)
      file=$csrc/ssd_scan.cu phase=card
      old='const float e = expf(cum[i]);'
      new='const float e = c == 0 ? expf(cum[i]) : 0.f;' ;;
    ssd_state_not_decayed)
      file=$csrc/ssd_scan.cu phase=card
      old='st[nt][e] *= decay;'
      new='st[nt][e] *= 1.f;' ;;
    ssd_slice_offset)
      file=$csrc/ssd_scan.cu phase=card
      old='const int p0 = blockIdx.x * PS,'
      new='const int p0 = 0 * blockIdx.x * PS,' ;;
    sgn_skip_dropped)
      file=$csrc/skip_gated_norm.cu phase=card
      old='return __fadd_rn(y, __fmul_rn(d, x));'
      new='return __fadd_rn(y, 0.f);' ;;
    sgn_group_offset)
      file=$csrc/skip_gated_norm.cu phase=card
      old='const float sum = gsum[gi];'
      new='const float sum = gsum[(gi + 1) % (units / ug)];' ;;
    sgn_fma_contracted)
      file=$csrc/skip_gated_norm.cu phase=card
      old='return __fadd_rn(y, __fmul_rn(d, x));'
      new='return fmaf(d, x, y);' ;;
    tp_attn_psum_dropped)
      file=models/attention.py phase=verify alone=tp_forward
      old='y = linear(p["wo"], out)
    return ctx.sp_enter(y)

'
      new='y = linear(p["wo"], out)
    return y

' ;;
    tp_vp_embed_shifted)
      file=parallel/collectives.py phase=verify alone=tp_forward
      old='off = rank * V_loc'
      new='off = (rank + 1) * V_loc' ;;
    decode_cache_head_offset)
      file=models/attention.py phase=verify alone=tp_decode
      old='cache["k"].index_copy_(2, write_at, knew)'
      new='cache["k"].index_copy_(2, write_at, knew.roll(1, 1) if ctx.tp_axis else knew)' ;;
    sp_gather_wrong_dim)
      file=parallel/ctx.py phase=tpdp_train alone="sp_forward verify"
      old='return self.gather_tp(x, seq_axis)'
      new='return self.gather_tp(x, -1).reshape(*x.shape[:seq_axis], -1, x.shape[-1])' ;;
    dp_rank_rows_swapped)
      file=parallel/spmd.py phase=dp_forward alone=
      old='batch = {"tokens": tokens[rank * rows:(rank + 1) * rows].to(dev)}'
      new='batch = {"tokens": tokens[(world - 1 - rank) * rows:(world - rank) * rows].to(dev)}' ;;
    sp_frontend_prev_chunk)
      file=models/model.py phase=verify alone=
      old='x = dynamic_slice_in_dim(x, ctx.tp_index() * chunk, chunk, axis=1)'
      new='x = dynamic_slice_in_dim(x, (ctx.tp_index() - 1) * chunk, chunk, axis=1)' ;;
    moe_shared_psum_dropped)
      file=models/mlp.py phase=verify alone=
      old='y = ctx.psum_tp(y).reshape(B, S, D)
    if "shared" in p:
        y = y + ctx.psum_tp(_shared_fwd(cfg, p["shared"], x))'
      new='y = ctx.psum_tp(y).reshape(B, S, D)
    if "shared" in p:
        y = y + _shared_fwd(cfg, p["shared"], x)' ;;
    moe_dispatch_pos_off_by_one)
      file=models/mlp.py phase="moe dispatch" alone=
      old='pos = (torch.cumsum(onehot, dim=1, dtype=torch.int32) * onehot).sum(0) - 1'
      new='pos = (torch.cumsum(onehot, dim=1, dtype=torch.int32) * onehot).sum(0)' ;;
    pipeline_ring_stalled)
      file=parallel/pipeline.py phase=pipeline_forward alone=
      old='inflight = ring_shift(act, group, n_stages)'
      new='inflight = act if t == 1 else ring_shift(act, group, n_stages)' ;;
    tpdp_psum_on_data_group)
      file=parallel/ctx.py phase=verify alone=tpdp_forward
      old='return self._all_reduce(x, "sum") if self.tp_axis else x

    def pmax_tp'
      new='return self._all_reduce(x, "sum", self.axis_group(self.dp_axis[0]) if self.mesh_axes and self.dp_axis else None) if self.tp_axis else x

    def pmax_tp' ;;
    train_kernel_path_unguarded)
      file=kernels/ops.py phase=train alone=
      old='    if not torch.is_grad_enabled():
        return'
      new='    if True:
        return'
      file2=chip_smoke.py
      old2='model = Model(cfg, impl="reference", device="cuda")  # the trainer'"'"'s path'
      new2='model = Model(cfg, impl="kernel", device="cuda")  # the trainer'"'"'s path' ;;
    loss_label_psum_dropped)
      file=models/model.py phase=tpdp_train alone=
      old='label_logit = ctx.psum_tp(torch.where(tgt, lf, 0.0).sum(-1))'
      new='label_logit = torch.where(tgt, lf, 0.0).sum(-1)' ;;
    dp_grad_psum_dropped)
      file=train/trainer.py phase=tpdp_train alone=
      old='grads = allreduce_compressed(grads, tcfg.grad_compress, ctx.dp_axis, ctx)'
      new='grads = grads' ;;
    dp_grad_mean_undivided)
      file=train/trainer.py phase=tpdp_train alone=
      old='grads = tree_map(lambda g: g / ctx.dp_size, grads)'
      new='grads = tree_map(lambda g: g / 1, grads)' ;;
    dp_grad_psum_dropped_rank)
      file=parallel/spmd.py phase=dp_grad alone=dp_grad_run
      old='return tree_map(model.ctx.psum_dp, grads)'
      new='return grads' ;;
    cp_merge_uncorrected)
      file=models/attention.py phase=cp_decode alone=
      old='corr = torch.exp(m - m_g)'
      new='corr = torch.ones_like(m)' ;;
    lint_pass_disabled)
      file=analysis/lints.py phase=lint alone=campaign
      old='    for leak in ctx.placement.leaks:'
      new='    for leak in ctx.placement.leaks[:0]:' ;;
    roofline_peak_div100)
      file=launch/analysis.py phase=roofline alone=
      old='PEAK_FLOPS = 989e12  # dense bf16 FLOP/s a GPU'
      new='PEAK_FLOPS = 989e12 / 100  # dense bf16 FLOP/s a GPU' ;;
    dryrun_micro_mult_dropped)
      file=scope.py phase=dryrun alone=
      old='    if loop not in _counting or n <= 1 or not fx_traceback.has_preserved_node_meta():'
      new='    if loop not in _counting or n <= 1 or loop == "micro" or not fx_traceback.has_preserved_node_meta():' ;;
    *) echo "unknown fault $name"; exit 2 ;;
  esac
  dir=$work/$name
  mkdir -p "$dir"
  mkdir -p "$dir/tests"
  cp -r "$root/src" "$dir/"
  cp "$root/tests/card_cases.py" "$dir/tests/"  # the kernels' case tables
  if [ "$phase" = card ]; then
    cp "$root/conftest.py" "$root/pyproject.toml" "$dir/"
    cp "$root/tests/test_torch_card_kernels.py" "$dir/tests/"
  else
    cp "$root/chip_smoke.py" "$dir/"
  fi
  rm -rf "$dir/src/repro_torch/kernels/build"
  cu=$dir/src/repro_torch/$file
  edits="$cu|$root/src/repro_torch/$file"
  [ -n "$file2" ] && edits="$edits $dir/$file2|$root/$file2"
  for edit in $edits; do
    path=${edit%%|*}
    if [ "$path" = "$cu" ]; then o=$old n=$new; else o=$old2 n=$new2; fi
    OLD=$o NEW=$n python3 - "$path" <<'PY'
import os, sys
path = sys.argv[1]
text = open(path).read()
old, new = os.environ["OLD"], os.environ["NEW"]
if text.count(old) != 1:
    sys.exit(f"{path}: the text to replace occurs {text.count(old)} times")
open(path, "w").write(text.replace(old, new))
PY
    if cmp -s "$path" "${edit#*|}"; then
      echo "$name: the edit of $path did not apply"
      exit 2
    fi
  done
  if [ "$phase" = card ]; then
    (cd "$dir" && timeout 900 python3 -m pytest -q -m card tests/test_torch_card_kernels.py) \
      > "$out/fault_$name.txt" 2>&1
    echo "$name: card tests exit $?"
  else
    (cd "$dir" && timeout 900 python3 chip_smoke.py) > "$out/fault_$name.txt" 2>&1
    echo "$name: chip_smoke.py exit $?"
  fi
  diff "$root/src/repro_torch/$file" "$cu" | grep '^>'
  [ -n "$file2" ] && diff "$root/$file2" "$dir/$file2" | grep '^>'
  grep -E "\"$phase\"|^FAILED|^[0-9]+ (passed|failed)" "$out/fault_$name.txt" | cut -c 1-600
  grep -a -o -m 1 -E "[A-Za-z]*Error: .{0,400}" "$out/fault_$name.txt"
  for a in $alone; do  # each phase that runs this program, on its own
    (cd "$dir" && timeout 600 python3 -c "
import chip_smoke as cs
cs.run_alone('$a')
") > "$out/fault_${name}_$a.txt" 2>&1
    echo "$name: $a phase alone exit $?"
    grep -E "\"${a%_run}\"" "$out/fault_${name}_$a.txt" | cut -c 1-600
    grep -a -o -m 1 -E "[A-Za-z]*Error: .{0,400}" "$out/fault_${name}_$a.txt"
  done
done
