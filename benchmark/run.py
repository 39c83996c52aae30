"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It needs as many CUDA cards as the cell
asks for and exits non-zero without a result otherwise; it never falls
back to the CPU. The last line of standard output is the result's JSON
object; the numbers that decided `correct`, each beside its limit, are the
last lines of standard error and the result's last key.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache the program or its libraries keep lives inside the checkout
    # (the program's own nvcc build already goes to build/kernels/ there)
    cache = os.path.join(ROOT, "benchmark", "cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    # and so does Python's bytecode: without it every run compiles the
    # sources of what torch imports again (torch.use_deterministic_algorithms
    # imports torch._inductor and torch._dynamo on the first frame)
    sys.pycache_prefix = os.path.join(cache, "pycache")
    sys.dont_write_bytecode = False
    sys.path.insert(0, ROOT)

    import torch

    from benchmark import harness

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result, lines = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                                torch.device("cuda", 0), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"modules that must not load in the benchmark were loaded: {found}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
