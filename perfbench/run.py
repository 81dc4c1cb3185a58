"""Run one cell of the benchmark once and print its result line.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's configuration, traffic and limits are
found by name under `perfbench/`; the metrics it reports, in BENCHMARK.json.
With `--trace 0` the line holds the cell's end-to-end metrics (where one
comes from the device trace, the window runs under the profiler), with
`--trace 1` its per-layer metrics and the device's busy time. Without a CUDA
card, or with a module of JAX or of the JAX package loaded once the window
has closed, the run prints no result and exits with a code other than 0.
"""
from __future__ import annotations

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import sys  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(args: argparse.Namespace, device=None, cell=None) -> tuple[dict, dict]:
    """(result, checks) of one run. `device` None asks for the card the cell
    needs, and `cell` None reads the workload's files; the tests pass the CPU
    and a cell cut to a tiny size."""
    import torch

    from perfbench import core

    core.env_for_caches()
    cell = core.Cell(args.workload) if cell is None else cell
    if device is None:
        device = core.require_cuda(cell.entry["chips"])
    traffic = cell.traffic().Traffic(cell.config, cell.spec, args.seed, device)
    # a cell with an end-to-end metric from the device trace runs its window under the profiler
    by_trace = any(m["source"] == "device_trace" for m in cell.e2e)
    if by_trace and not args.trace:
        core.warm_profiler(traffic, device)
    setup_s = time.perf_counter() - _STARTED
    before = traffic.done

    if args.trace:
        reading = core.traced(traffic, args.seconds, device)
        attempted = traffic.done - before
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        if by_trace:
            times, wall, busy = core.profiled_window(traffic, args.seconds, device)
        else:
            times, wall = core.window(traffic, args.seconds, device)
        attempted = len(times)
        values = traffic.e2e(times, wall)
        if by_trace:
            values["device_ms"] = 1e3 * busy / len(times)  # the device's busy time a step or frame
        # the workload may report a traffic's number under a metric name of its own
        names = cell.spec.get("metrics", {})
        values = {names.get(k, k): v for k, v in values.items()}
        values["setup_s"] = setup_s
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.e2e}

    found = core.forbidden_loaded()
    if found:
        raise core.RunError(f"modules of JAX or the JAX package loaded: {', '.join(found)}")
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": cell.entry["chips"],
                "memory_peak_bytes": reading.peak_bytes if args.trace else core.peak_bytes(device)}
    result = {"correct": False, "attempted": attempted, "failed": 0, "metrics": metrics, "device": dev_info}
    if args.trace:
        result["device"].update(busy_s=reading.trace["busy_s"], window_s=reading.window_s)
        result["breakdown"] = {"device_ops": reading.trace["device_ops"], "idle_gaps": reading.trace["idle_gaps"]}
    traffic.close()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = traffic.check()
    result["correct"] = all(v <= lim for v, lim in checks.values())
    return result, checks


def main(argv=None) -> int:
    args = parse(argv)
    from perfbench import core

    try:
        result, checks = run(args)
    except core.RunError as err:
        print(f"perfbench: {err}", file=sys.stderr)
        return 2
    found = core.forbidden_loaded()
    if found:
        print(f"perfbench: modules of JAX or the JAX package loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"card and power limit: {core.power_limit()}", file=sys.stderr)
    core.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
