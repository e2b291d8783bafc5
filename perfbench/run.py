"""The benchmark of ``glint_word2vec_torch`` on NVIDIA GPUs.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs one cell (``perfbench/workloads/<name>.json``) on the card this
process finds and prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``, each number compared with the reference beside its limit
(also the last lines of standard error). Without a CUDA card, or with
fewer than the cell asks for, it exits 2 and prints no result; it exits 3
and prints no result if JAX or the JAX package was loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# Run as a script, this folder heads sys.path, where its modules would
# shadow others of the same name (``trace``); the checkout's root goes
# there instead, so ``perfbench`` and the program import as packages.
_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _HERE]
sys.path.insert(0, _ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available():
        harness.log("no CUDA device: the benchmark measures the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        harness.log(f"the cell asks for {cell.chips} cards, "
                    f"{torch.cuda.device_count()} found")
        return 2
    torch.set_num_threads(4)
    harness.log(f"card: {harness.nvidia_smi()}; torch {torch.__version__}, "
                f"CUDA {torch.version.cuda}")
    line = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0), T_START)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"loaded in this process: {', '.join(bad)}; the benchmark "
                    "runs the PyTorch port alone")
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
