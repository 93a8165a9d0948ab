"""Run the examples in one process, each as its file would run alone:

    python -m alphafold2_tpu_torch.examples [01 02 ...] [--device cpu]
    torchrun --standalone --nproc_per_node 1 -m alphafold2_tpu_torch.examples

Every example by default, in order; 05 needs torchrun's environment, so
without torchrun name the others. Each example's output follows a line
``== <file>``, and each ends by printing ``ok``.
"""

import argparse
import glob
import os
import runpy
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*", help="example prefixes (01 ... 05); all by default")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    paths = sorted(glob.glob(os.path.join(HERE, "0*.py")))
    if args.names:
        paths = [p for p in paths if os.path.basename(p)[:2] in args.names]
    for path in paths:
        print(f"== {os.path.basename(path)}", flush=True)
        sys.argv = [path] + (["--device", args.device] if args.device else [])
        runpy.run_path(path, run_name="__main__")


if __name__ == "__main__":
    main()
