#!/bin/bash
# Kernel #8, parent against change on one card: chip_smoke.py's phase 16
# (the SSD scan's rows), then phase 18 (zamba2-7b serving, the profiled
# prefill tick), each from its own checkout's root in turns parent,
# change, change, parent; after each parent phase 16,
# scripts/ssd_f32_copies.py times the parent on the bf16 rows' values.
#
#   bash scripts/ssd_ab.sh PARENT_CHECKOUT [OUT_DIR]
#
# Run from the change's root. Logs go to OUT_DIR (default build/ssd_ab); the
# key lines are printed.
set -u
CH=$(pwd); PA=$(cd "$1" && pwd); OUT=${2:-$CH/build/ssd_ab}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
(cd "$PA" && python3 -c "import chip_smoke as c; c._build.build_all()") > "$OUT/build_parent.log" 2>&1 &
(cd "$CH" && python3 -c "import chip_smoke as c; c._build.build_all()") > "$OUT/build_change.log" 2>&1 &
wait
PRE="import chip_smoke as c, torch; torch.backends.cuda.matmul.allow_tf32=False; torch.backends.cudnn.allow_tf32=False; card=c.card_line()"
n=0
for phase in 16 18; do
  for who in parent change change parent; do
    n=$((n+1)); dir=$CH; [ $who = parent ] && dir=$PA
    if [ $phase = 16 ]; then cmd="$PRE; c.phase_ssd_kernel(card)"; else cmd="$PRE; c.phase_zamba2_full(card)"; fi
    (cd "$dir" && python3 -c "$cmd") > "$OUT/p${phase}_${n}_${who}.log" 2>&1
    echo "== phase $phase run $n $who rc=$?"
    if [ $phase = 16 ] && [ $who = parent ]; then
      (cd "$dir" && python3 "$CH/scripts/ssd_f32_copies.py") > "$OUT/p16b_${n}_parent.log" 2>&1
      echo "   parent on bf16 values rc=$?"
    fi
    grep -h "\[kernel\] ssd_scan zamba2\|\[parent\]\|\[profile\]\|\[zamba2\] \(prefill_tok_s\|decode_tok_s\|ttft\|tpot\|launches\)" "$OUT/p${phase}_${n}_${who}.log" "$OUT/p16b_${n}_parent.log" 2>/dev/null | sed 's/ | NVIDIA.*//' | cut -c1-250
  done
done
