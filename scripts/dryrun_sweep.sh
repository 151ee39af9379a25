#!/usr/bin/env bash
# The one-card dry-run of every (architecture x input shape) pair, the
# federated modes at train_4k, and the spec-level records of both
# production meshes, in five parallel processes, then the roofline tables.
#
#   bash scripts/dryrun_sweep.sh [OUT_DIR] [DEVICE]
#
# OUT_DIR defaults to results_torch/dryrun_sweep, DEVICE to cuda (the
# plan's device: fake tensors of it, no memory). Each process logs to
# OUT_DIR/log_*.txt; the tables go to OUT_DIR/tables.md. Exits non-zero
# when any pair fails.
set -u
OUT=${1:-results_torch/dryrun_sweep}
DEVICE=${2:-cuda}
mkdir -p "$OUT"
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
DRY="python3 -m repro_torch.launch.dryrun --device $DEVICE --out $OUT"

traced() {
  local args=""
  for a in "$@"; do args="$args --arch $a"; done
  { $DRY $args; echo "rc_baseline=$?"
    $DRY $args --shape train_4k --mode feddcl; echo "rc_feddcl=$?"
    $DRY $args --shape train_4k --mode feddcl_sync; echo "rc_sync=$?"
  } > "$OUT/log_$1.txt" 2>&1
}

start=$(date +%s)
traced deepseek-v3-671b llama3.2-1b &
traced chameleon-34b gemma2-2b granite-moe-1b-a400m &
traced starcoder2-15b rwkv6-3b &
traced glm4-9b zamba2-1.2b musicgen-large &
{ $DRY --all --both-meshes; echo "rc_specs=$?"
  $DRY --both-meshes --shape train_4k --mode feddcl; echo "rc_specs_fed=$?"
  $DRY --both-meshes --shape train_4k --mode feddcl_sync; echo "rc_specs_sync=$?"
} > "$OUT/log_specs.txt" 2>&1 &
wait
echo "sweep_s=$(( $(date +%s) - start ))"
grep -h "^rc_\|FAIL" "$OUT"/log_*.txt
python3 -m repro_torch.launch.roofline_table "$OUT" --md "$OUT/tables.md" \
  > "$OUT/table_stdout.txt" 2>&1
head -4 "$OUT/table_stdout.txt"
! grep -q "^rc_.*=[^0]" "$OUT"/log_*.txt
