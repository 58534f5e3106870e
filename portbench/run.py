"""The benchmark of sdnmpi_tpu_torch on one NVIDIA H100.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout and prints
its result as the last line of standard output, one JSON object; the
numbers the correctness check compared, each beside its limit, are the
last lines of standard error and the result's last key. With
``--trace 0`` the metrics are the cell's end-to-end ones, with
``--trace 1`` its per-layer ones, read from a profile of the window.
Exits non-zero and prints no result without a CUDA card, where the
program is missing, or where a fenced module (JAX, or the JAX package)
was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
BUILD = ROOT / "portbench" / "build"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # every build and kernel cache of the run inside the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    sys.path.insert(0, str(ROOT))
    if not (ROOT / "sdnmpi_tpu_torch" / "__init__.py").exists():
        print("portbench: the program (sdnmpi_tpu_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              "available", file=sys.stderr)
        return 2

    from sdnmpi_tpu_torch.kernels import _build

    from portbench import harness

    _build.set_build_dir(BUILD / "kernels")
    try:
        result, lines = harness.run_cell(
            ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
            torch.device("cuda", 0), T_START)
    except harness.FencedImport as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 3
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip()
    print(f"card: {card or torch.cuda.get_device_name()}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
