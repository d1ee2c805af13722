#!/usr/bin/env bash
# Run chip_smoke.py in throwaway copies of the tree, each with one fault
# planted in a kernel source, and print each run's exit code and the kernel
# lines of the faulty kernel.  A sound check fails every copy.  Needs one
# H100, like chip_smoke.py.
#
#   bash scripts/planted_faults.sh [OUT_DIR]    # full logs: OUT_DIR/fault_*.txt
#
# Faults in csrc/flash_attention.cu (K1):
#   fa_diagonal_unmasked  the causal mask is not applied (only keys past Sk
#                         are masked), so the diagonal tiles see future keys
#   fa_last_kv_stale      the producer fills the last KV stage of each q-tile
#                         with the previous tile's keys: the last K tile is
#                         dropped
# Faults in csrc/ssd_scan.cu (K3):
#   ssd_carry_dropped     the incoming state's contribution to y (y_off) is
#                         dropped after the first chunk
#   ssd_state_not_decayed the carried state is not decayed by exp(cum_Q)
#   ssd_slice_offset      every P-slice block reads and writes the first
#                         slice's columns
set -u
root=$(cd "$(dirname "$0")/.." && pwd)
out=${1:-$root/chiprun_out}
work=$(mktemp -d)
trap 'rm -rf "$work"' EXIT
mkdir -p "$out"
csrc=src/repro_torch/kernels/csrc
for name in fa_diagonal_unmasked fa_last_kv_stale ssd_carry_dropped ssd_state_not_decayed \
            ssd_slice_offset; do
  case $name in
    fa_diagonal_unmasked)
      file=flash_attention.cu phase=flash_attention
      old='if (kpos >= Sk || (causal && qpos[(i >> 1) & 1] < kpos)) s[i] = kNeg;'
      new='if (kpos >= Sk) s[i] = kNeg;' ;;
    fa_last_kv_stale)
      file=flash_attention.cu phase=flash_attention
      old='j * T::BK, bkv);
          mbar_wait(v_empty(s), parity);'
      new='(j - (j > 0 && j == n_kv - 1)) * T::BK, bkv);
          mbar_wait(v_empty(s), parity);' ;;
    ssd_carry_dropped)
      file=ssd_scan.cu phase=ssd_scan
      old='const float e = expf(cum[i]);'
      new='const float e = c == 0 ? expf(cum[i]) : 0.f;' ;;
    ssd_state_not_decayed)
      file=ssd_scan.cu phase=ssd_scan
      old='st[nt][e] *= decay;'
      new='st[nt][e] *= 1.f;' ;;
    ssd_slice_offset)
      file=ssd_scan.cu phase=ssd_scan
      old='const int p0 = blockIdx.x * PS,'
      new='const int p0 = 0 * blockIdx.x * PS,' ;;
  esac
  dir=$work/$name
  mkdir -p "$dir"
  cp -r "$root/chip_smoke.py" "$root/src" "$dir/"
  rm -rf "$dir/src/repro_torch/kernels/build"
  cu=$dir/$csrc/$file
  OLD=$old NEW=$new python3 - "$cu" <<'PY'
import os, sys
path = sys.argv[1]
text = open(path).read()
old, new = os.environ["OLD"], os.environ["NEW"]
if text.count(old) != 1:
    sys.exit(f"{path}: the text to replace occurs {text.count(old)} times")
open(path, "w").write(text.replace(old, new))
PY
  if cmp -s "$cu" "$root/$csrc/$file"; then
    echo "$name: the edit did not apply"
    exit 2
  fi
  (cd "$dir" && timeout 900 python3 chip_smoke.py) > "$out/fault_$name.txt" 2>&1
  echo "$name: chip_smoke.py exit $?"
  diff "$root/$csrc/$file" "$cu" | grep '^>'
  grep "\"kernel $phase\"" "$out/fault_$name.txt" | cut -c 1-330
  grep -m 1 -E "AssertionError|Error:" "$out/fault_$name.txt" | cut -c 1-400
done
