#!/bin/bash
# Compare two checkouts of the port on one card, in turns: chip_smoke.py
# phases for PARENT, this tree, this tree, PARENT.
#
#   bash chip_compare.sh PARENT_DIR [PHASES]
#
# PARENT_DIR: e.g. a `git archive` of the parent unpacked under _checkout/.
# PHASES: chip_smoke.py functions to run, default "phase_serve phase_train"
# (serving throughput, device busy time, training step times);
# "phase_k1_time" times K1 alone on its nine main-path passes.
# Builds both trees' kernels first (in parallel), then writes each run's
# log to chiprun_out/cmp/<n>.<parent|change>.log and prints its numbers.
set -u
parent=${1:?usage: bash chip_compare.sh PARENT_DIR [PHASES]}
phases=${2:-phase_serve phase_train}
calls=$(for f in $phases; do printf 'c.%s(); ' "$f"; done)
mkdir -p chiprun_out/cmp
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
(cd "$parent" && python3 -c "import chip_smoke as c; c.phase_build()") \
    > chiprun_out/cmp/build_parent.log 2>&1 &
python3 -c "import chip_smoke as c; c.phase_build()" > chiprun_out/cmp/build_change.log 2>&1 &
wait
i=0
for who in parent change change parent; do
  i=$((i + 1))
  dir=.
  [ "$who" = parent ] && dir=$parent
  (cd "$dir" && timeout 400 python3 -c "import chip_smoke as c; $calls") \
      > "chiprun_out/cmp/$i.$who.log" 2>&1
  echo "== $i $who rc=$?"
  grep -h "residues/s\|device busy\|the step alone\|warm step latency\|k1 time" \
      "chiprun_out/cmp/$i.$who.log" | cut -c1-220
done
