"""The readings that the limits of ``correct`` are set from, on the card:

    python3 -m ucg_bench.calibrate --workload <cell> --seeds 1,2,... \\
        --seconds 3 [--control 3]

runs the cell once a seed in one process, each with a short window at the
cell's own size, and prints one JSON line a seed: the numbers the program
gives (``program``) and, on the first ``--control`` seeds, the numbers the
control gives (``control``: the reference computed in bfloat16, the
precision below the configuration's float32, put in the program's place).
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m ucg_bench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, default=3)
    a = ap.parse_args(argv)
    import torch

    from ucg_bench import harness
    if not torch.cuda.is_available():
        harness.say("no CUDA card")
        return 2
    for k, seed in enumerate(int(s) for s in a.seeds.split(",")):
        res = harness.run_cell(a.workload, seed, a.seconds, False,
                               control=k < a.control, calibrate=True)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "correct": res["correct"],
                          "program": res["numbers"],
                          "control": res.get("control"),
                          "metrics": {n: v["value"] for n, v in
                                      res["metrics"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
