#!/usr/bin/env bash
# Run chip_smoke.py in throwaway copies of the tree, each with one fault
# planted in the SSD scan kernel (csrc/ssd_scan.cu), and print each run's
# exit code and its "kernel ssd_scan" lines.  A sound check fails every
# copy.  Needs one H100, like chip_smoke.py.
#
#   bash scripts/planted_faults.sh [OUT_DIR]    # full logs: OUT_DIR/fault_*.txt
#
# Faults:
#   yoff_after_first_chunk  the incoming state's contribution to y (y_off)
#                           is dropped after the first chunk
#   state_not_decayed       the carried state is not decayed by exp(cum_Q)
set -u
root=$(cd "$(dirname "$0")/.." && pwd)
out=${1:-$root/chiprun_out}
work=$(mktemp -d)
trap 'rm -rf "$work"' EXIT
mkdir -p "$out"
src=$root/src/repro_torch/kernels/csrc/ssd_scan.cu
for name in yoff_after_first_chunk state_not_decayed; do
  case $name in
    yoff_after_first_chunk)
      edit='s/yd\[i\]\[k\] + e \* yo\[i\]\[k\]/yd[i][k] + (c == 0 ? e * yo[i][k] : 0.f)/' ;;
    state_not_decayed)
      edit='s/srow\[tx + 16 \* k\] \* decay + acc/srow[tx + 16 * k] + acc/' ;;
  esac
  dir=$work/$name
  mkdir -p "$dir"
  cp -r "$root/chip_smoke.py" "$root/src" "$dir/"
  cu=$dir/src/repro_torch/kernels/csrc/ssd_scan.cu
  sed -i "$edit" "$cu"
  if cmp -s "$cu" "$src"; then
    echo "$name: the edit did not apply"
    exit 2
  fi
  (cd "$dir" && timeout 900 python3 chip_smoke.py) > "$out/fault_$name.txt" 2>&1
  echo "$name: chip_smoke.py exit $?"
  diff "$src" "$cu" | grep '^>'
  grep '"kernel ssd_scan"' "$out/fault_$name.txt" | cut -c 1-330
done
