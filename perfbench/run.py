"""Run one cell of the benchmark once:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the result as the last line of
standard output (one JSON object) and each number the check compared,
beside its limit, as the last lines of standard error.  Exits non-zero,
printing no result, without enough CUDA devices, or if the process holds
JAX or the JAX package once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".perfbench_cache")
# every build and kernel cache inside the checkout, at fixed paths (the
# port's nvcc libraries go to metatts_torch/csrc/build/, its own fixed path)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
# run as a script, the folder itself is first on the path: take the root
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") not in (HERE, ROOT)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from perfbench import harness
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    spec = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if spec is None:
        sys.exit(f"no workload {args.workload!r} in BENCHMARK.json")
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        sys.exit(f"{args.workload} needs {spec['chips']} CUDA device(s); "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
    result, checks = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                      bench=bench, t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        sys.exit(f"the process holds {', '.join(bad)} after the window: refused")
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
