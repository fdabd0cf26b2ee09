#!/usr/bin/env bash
# Run the lines of a jobs file on one card, SLOTS at a time, every job stopped at a common deadline.
#
#     bash tools/chip_queue.sh JOBS SLOTS SECONDS OUT
#
# Each line of JOBS is "<name> <python module> [arguments...]"; its output goes to OUT/<name>.log and
# "END <name> rc=<rc> after <s> s" to stdout (rc 124: cut at the deadline; the run keeps the curve it
# wrote).  A job that would start with a minute or less left is skipped.  The card's name and power
# limit go to OUT/smi.txt, and nvidia-smi samples utilisation, power and memory every 120 s into
# OUT/smi_samples.csv until the queue ends.
set -u
jobs_file=$1 slots=$2 seconds=$3 out=$4
mkdir -p "$out"
export PYTHONPATH="$(cd "$(dirname "$0")/.." && pwd)${PYTHONPATH:+:$PYTHONPATH}" OMP_NUM_THREADS=1
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/smi.txt"
nvidia-smi --query-gpu=timestamp,utilization.gpu,power.draw,clocks.sm,memory.used --format=csv -l 120 \
  > "$out/smi_samples.csv" &
smi_pid=$!
deadline=$(( $(date +%s) + seconds ))
export deadline out
job() {
  local name=$1; shift
  local left=$(( deadline - $(date +%s) ))
  [ "$left" -gt 60 ] || { echo "SKIP $name"; return 0; }
  local start=$(date +%s)
  timeout -k 20 "$left" python3 -m "$@" > "$out/$name.log" 2>&1
  echo "END $name rc=$? after $(( $(date +%s) - start )) s"
}
export -f job
xargs -P "$slots" -L 1 bash -c 'job "$@"' _ < "$jobs_file"
kill "$smi_pid"
wait
