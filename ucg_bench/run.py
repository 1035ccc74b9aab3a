"""The benchmark's command:

    python3 -m ucg_bench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Runs one cell of BENCHMARK.json on the cards of this machine and prints, as
its last line on standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``, each number the check of ``correct``
compared with its limit (also the last lines on standard error).  Exits
with 2, printing no result, without enough CUDA cards, and with 3 when
JAX, Flax or the JAX package was loaded in this process or in any rank of
a cell on several cards.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from ucg_bench.nojax import ForbiddenLoaded, forbidden_loaded


def line(res: dict) -> str:
    return json.dumps(res)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m ucg_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    from ucg_bench import harness
    cell = harness.cell_of(harness.benchmark(), a.workload)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < int(cell["chips"])):
        have = (torch.cuda.device_count() if torch.cuda.is_available()
                else 0)
        harness.say(f"{a.workload} needs {cell['chips']} CUDA card(s); "
                    f"this machine has {have}")
        return 2
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi failed: {e}"
    harness.say(f"[card] {smi.splitlines()[0] if smi else smi} "
                f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    try:
        res = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    except ForbiddenLoaded as e:
        harness.say(str(e))
        return 3
    bad = forbidden_loaded()
    if bad:
        harness.say(str(ForbiddenLoaded({"main": bad})))
        return 3
    print(line(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
