"""The control of each cell's comparison, on the card at the cell's size.

    python3 -m portbench.control --workload <cell> --seconds <s> \
        --seed <n> [<n> ...]

For each seed: the cell's set-up, then a short window in which the
reference, computed with its similarities (or scores) rounded to bfloat16,
the precision below the configuration's float32, stands in the program's
place, then the cell's comparison with the float32 reference. Prints each
seed's compared numbers, one JSON line a seed. A control that any number
fails is what sets a limit's upper reading; the benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench.run import ROOT, load_spec, run_cell, set_cache_dirs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    set_cache_dirs(ROOT)

    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    spec = load_spec()
    for seed in args.seed:
        line = run_cell(spec, args.workload, seed, args.seconds, False,
                        torch.device("cuda", 0), control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": line["correct"],
                          "attempted": line["attempted"],
                          "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
