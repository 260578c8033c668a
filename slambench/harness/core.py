"""One run of one cell: load the cell's files by name, set up its driver,
measure, check, print the result line.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

The cell ``slambench/workloads/<cell>.json`` names its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<traffic>.json``,
which names its driver ``drivers/<driver>.py``) and the end-to-end metrics
it reports. With ``--trace 1`` every reader ``metrics/<metric>.py`` whose
``MOVES`` is one of the cell's end-to-end metrics reads the traced record;
a reader that finds nothing returns None and its metric is left out.
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "coxgraph_tpu"}


def load_json(*parts) -> dict:
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def load_module(path: str):
    name = "slambench_" + os.path.splitext(os.path.basename(path))[0] \
        .replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str) -> dict:
    """The cell's files, resolved: workload, config, traffic, driver."""
    w = load_json("workloads", name + ".json")
    cfg = load_json("configs", w["config"] + ".json")
    mix = dict(load_json("traffic", w["traffic"] + ".json"),
               limits=w["limits"])
    drv = load_module(os.path.join(BENCH, "drivers", mix["driver"] + ".py"))
    return {"name": name, "workload": w, "config": cfg, "traffic": mix,
            "driver": drv}


def readers(e2e) -> dict:
    """{metric name: reader module} of the readers that move one of the
    end-to-end metrics ``e2e``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(BENCH, "metrics", "*.py"))):
        mod = load_module(path)
        if getattr(mod, "MOVES", None) in e2e:
            out[os.path.splitext(os.path.basename(path))[0]] = mod
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def parse(argv):
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str) -> int:
    print(f"slambench: {msg}", file=sys.stderr)
    return 2


def run(argv, t_start: float, device_check: bool = True,
        out=sys.stdout) -> int:
    args = parse(argv)
    c = cell(args.workload)
    import torch

    chips = int(c["workload"]["chips"])
    if device_check:
        if not torch.cuda.is_available():
            return fail("no CUDA device")
        if torch.cuda.device_count() < chips:
            return fail(f"{torch.cuda.device_count()} CUDA devices, the "
                        f"cell asks for {chips}")
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")
    driver = c["driver"].Driver(c["config"], c["traffic"], args.seed, device)
    driver.setup()
    setup_s = time.perf_counter() - t_start
    record = driver.trace() if args.trace else None
    e2e = driver.window(args.seconds)
    bad = forbidden_modules()
    if bad:
        return fail(f"modules of the JAX package loaded: {bad}")
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    checks = driver.check()
    correct = (all(v <= lim for _, v, lim in checks)
               and e2e["failed"] == 0 and e2e["attempted"] > 0)

    units = c["workload"]["end_to_end"]
    wanted = list(units)
    metrics = {}
    if args.trace:
        for name, mod in readers(wanted).items():
            v = mod.read(record)
            if v is not None:
                metrics[name] = {"value": v, "unit": mod.UNIT}
    else:
        for name in wanted:
            metrics[name] = {"value": e2e[name], "unit": units[name]}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": e2e["attempted"],
            "failed": e2e["failed"], "metrics": metrics, "device": dev}
    if args.trace:
        dev["busy_s"] = record["busy_s"]
        dev["window_s"] = record["window_s"]
        line["breakdown"] = {"device_ops": record["device_ops"],
                             "idle_gaps": record["idle_gaps"]}
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for n, v, lim in checks:
        print(f"check {n} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAIL'}", file=sys.stderr)
    out.write(json.dumps(line) + "\n")
    out.flush()
    return 0
