#!/bin/bash
# Runs one command in two checkouts in turn, the other one first: other,
# this, this, other, each run's output after a "=== run N: DIR ===" line,
# so that two versions of the kernels are compared on one card in one
# call.  Stops at the first run that fails.
#
#   bash segdino3d_tpu_torch/tools/paired_run.sh OTHER_DIR COMMAND [ARGS...]
#
# OTHER_DIR is another checkout unpacked inside this one, in a directory
# that .gitignore lists (git archive PARENT | tar -x -C build/parent); copy
# into it the benchmark files it lacks.  Each checkout builds its kernels
# into its own build/.
set -o pipefail
other=$1
shift
n=0
for d in "$other" . . "$other"; do
  n=$((n + 1))
  echo "=== run $n: $d ==="
  (cd "$d" && "$@") || exit 1
done
