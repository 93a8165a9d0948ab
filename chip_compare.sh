#!/bin/bash
# Compare two checkouts of the port on one card, in turns: chip_smoke.py
# phases for PARENT, this tree, this tree, PARENT.
#
#   bash chip_compare.sh PARENT_DIR [PHASES]
#
# PARENT_DIR: e.g. a `git archive` of the parent unpacked under _checkout/.
# PHASES: chip_smoke.py functions to run, default "phase_serve phase_train"
# (serving throughput, device busy time, training step times);
# "phase_k1_time" times K1 alone on its nine main-path passes,
# "phase_k3_time" K3a and K3b alone on the five training passes (a phase the
# parent lacks runs from this tree's chip_smoke.py, on the parent's kernels);
# "phase_backward phase_train" times K1 (lse), K3a and K3b on the training
# passes (per call and per training step) beside the training step.
# Builds both trees' kernels first (in parallel), then writes each run's
# log to chiprun_out/cmp/<n>.<parent|change>.log and prints its numbers.
# The timed rows a phase returns are printed as `[kernels] time` lines, with
# the per-training-step sums of K1 (lse), K3a and K3b, in either tree.
set -u
parent=${1:?usage: bash chip_compare.sh PARENT_DIR [PHASES]}
phases=${2:-phase_serve phase_train}
here=$(pwd)
runner=$(cat <<'EOF'
import importlib.util
import os
import sys

sys.path.insert(0, os.getcwd())
import chip_smoke as c

# a phase the tree under test lacks (a parent older than the phase) runs
# from this tree's chip_smoke.py, against the tree's own package
spec = importlib.util.spec_from_file_location("chip_smoke_change", sys.argv[1])
change = importlib.util.module_from_spec(spec)
spec.loader.exec_module(change)

for phase in sys.argv[2:]:
    rows = (getattr(c, phase, None) or getattr(change, phase))()
    if not isinstance(rows, list):
        continue
    for r in rows:
        if "ms" in r:
            c.log(f"[kernels] time {r['kernel']} {r['label']} {r['dtype']}: kernel "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, sdpa "
                  f"{r.get('library_ms')} ms, bound {r['bound_ms']:.4f} ms")
    for name in ("fused_attention (lse)", "fused_attention_bwd_dq", "fused_attention_bwd_dkv"):
        if any(r["kernel"] == name and "ms" in r for r in rows):
            weights = c._step_weights(backward=name != "fused_attention (lse)")
            e = c._entry(name, "", "", None, rows, weights)
            c.log(f"[kernels] time {name} per training step: kernel {e['ms']:.3f} ms, "
                  f"sdpa {e['library_ms']} ms")
EOF
)
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
  (cd "$dir" && timeout 400 python3 -c "$runner" "$here/chip_smoke.py" $phases) \
      > "chiprun_out/cmp/$i.$who.log" 2>&1
  echo "== $i $who rc=$?"
  grep -h "residues/s\|device busy\|the step alone\|warm step latency\|k1 time\|k3 time\|time fused_attention" \
      "chiprun_out/cmp/$i.$who.log" | cut -c1-220
done
