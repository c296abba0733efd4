"""The readings that set a cell's limits, on the chip at the cell's size:

    python3 perfbench/control.py --workload <name> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--faults 4,5,6] [--seconds 5] [--out <jsonl>]

For each of ``--seeds`` the program's run (set-up, a short window at the
cell's own load, the check) and its readings; for each of
``--control-seeds`` the control's: the reference put in the program's
place at the precision below the configuration's (the acoustic model's
products in fp8, the vocoder's in bf16), compared as the program is; for
each of ``--faults`` every fault of ``faults.py`` that the cell can have,
planted in the timed path, with the run's readings and ``correct``.  One
process; one JSON line a reading.  The benchmark's own runs do not run
this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") not in (HERE, ROOT)]


def control_readings(cell):
    """The control's readings for a cell that has drawn its pool and made
    its weights (the program's set-up)."""
    from perfbench.drivers import common as C
    from perfbench.reference import model as R
    if cell.mix["entry"] == "synthesize":
        from perfbench.drivers.synthesize import compare, control_served
        items = [(i, C.with_tf32_off(lambda: control_served(cell, i)))
                 for i in range(len(cell.pool))]
        return C.with_tf32_off(lambda: compare(cell, items))
    from perfbench.drivers.training import as_program
    return cell.check(as_program(cell, R.Precision(R.BITS["fp8"])))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    from perfbench import faults, harness
    out = open(args.out, "a") if args.out else None
    seeds = lambda s: [int(x) for x in s.split(",") if x]

    def emit(**row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in seeds(args.seeds):
        t0 = time.perf_counter()
        res, _ = harness.run_cell(args.workload, seed, args.seconds, False)
        emit(kind="program", seed=seed, correct=res["correct"], checks=res["checks"],
             metrics=res["metrics"], seconds=time.perf_counter() - t0)
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    spec = next(w for w in bench["workloads"] if w["name"] == args.workload)
    for seed in seeds(args.control_seeds):
        t0 = time.perf_counter()
        entry = next(c for c in bench["configs"] if c["name"] == spec["config"])
        cfg = harness.load_json(os.path.join(ROOT, entry["file"]))
        from perfbench import traffic
        mix = traffic.load(spec["traffic"])
        cell = harness.driver(mix["entry"]).Cell(cfg, mix, seed, torch.device("cuda"))
        cell.setup()
        cell.free()
        emit(kind="control", seed=seed, readings=control_readings(cell),
             seconds=time.perf_counter() - t0)
        del cell
        torch.cuda.empty_cache()
    mix_entry = None
    for seed in seeds(args.faults):
        from perfbench import traffic
        mix_entry = mix_entry or traffic.load(spec["traffic"])["entry"]
        for name, patch in faults.BY_ENTRY[mix_entry].items():
            t0 = time.perf_counter()
            res, _ = harness.run_cell(args.workload, seed, args.seconds, False, patch=patch)
            emit(kind="fault", fault=name, seed=seed, correct=res["correct"],
                 checks=res["checks"], seconds=time.perf_counter() - t0)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
