"""Run one cell of the benchmark once and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cell's cards. The cell
is an entry of ``BENCHMARK.json``'s ``workloads``; its files are
``benchmark/cells/<cell>.json`` (the limits of its checks),
``benchmark/configs/<config>.json`` (the scene, camera and budgets) and
``benchmark/traffic/<traffic>.json`` (the mix, whose ``kind`` names the
generator ``benchmark/traffic/<kind>.py``). The per-layer metrics are
``benchmark/metrics/<metric>.json``, each read by
``benchmark/readers/<reader>.py``.

Set-up makes the inputs from ``--seed`` and warms up; then ``--trace 0``
measures the cell's end-to-end metrics over ``--seconds``, and ``--trace
1`` profiles a fixed stretch of the same traffic for its per-layer metrics.
Either way the reference then judges what the timed path produced. The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each compared number with its limit); the last lines of
standard error repeat the checks. Without a CUDA card, or with fewer than
the cell asks for, or with JAX or the JAX package loaded once the window
has closed, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
# Fixed directories inside the checkout: only a checkout's first run
# builds or compiles. The port builds its kernels into rtgs_tpu_torch/_build.
CACHE = ROOT / ".bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "rtgs_tpu")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str) -> dict:
    """The cell ``name`` with its configuration, mix, checks and the
    metrics ``BENCHMARK.json`` assigns it."""
    manifest = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}")
    cell = dict(entry, **load_json(BENCH / "cells" / f"{name}.json"))
    cell["config_data"] = load_json(BENCH / "configs"
                                    / f"{entry['config']}.json")
    cell["mix"] = load_json(BENCH / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [dict(m, **load_json(BENCH / "metrics" / f"{m['name']}.json"))
             for m in manifest["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    cell["end_to_end"], cell["per_layer"] = e2e, layer
    return cell


def workload(cell: dict, seed: int, device):
    mod = importlib.import_module(f"benchmark.traffic.{cell['mix']['kind']}")
    return mod.Workload(cell["config_data"], cell["mix"], seed, device)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device) -> dict:
    """One run of ``cell`` on ``device``; returns the result line's object
    (without the ``device`` entry's card fields)."""
    import torch

    w = workload(cell, seed, device)
    w.setup()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    if trace:
        rec, metrics, extra = _traced(cell, w, device)
    else:
        rec = w.run(seconds=seconds)
        # Wall-clock ends of the window, to set beside the machine's
        # clocks and load when runs drift.
        print(f"window: {time.time() - rec['window_s']:.3f} to "
              f"{time.time():.3f} (unix s)", file=sys.stderr)
        values = dict(w.end_to_end(rec),
                      setup_s=rec["start"] - _T0)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"] if m["name"] in values}
        extra = {}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    w.release()
    if on_card:
        torch.cuda.empty_cache()
    checks = w.check(rec)
    limits = cell["checks"]
    ok = all(math.isfinite(v) and v <= limits[k] for k, v in checks.items())
    out = {"correct": ok, "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics,
           "device": dict(memory_peak_bytes=peak, **extra.pop("device", {}))}
    out.update(extra)
    out["checks"] = {k: {"value": v, "limit": limits[k]}
                     for k, v in checks.items()}
    return out


def _traced(cell: dict, w, device):
    """Three stretches of ``traced_units`` each. The first is not traced:
    its wall time and peak memory. The second records only the card (the
    profiler's cost on the host is least there): device busy time, the
    traced window, kernels a unit, the operations that took most time. The
    third also records the host and the metrics' spans and launches: the
    layers' device times, the kernels' roofline shares, and what the host
    was doing in each idle gap."""
    import torch

    from benchmark import trace as TR

    spans, launches = [], {}
    for m in cell["per_layer"]:
        if m["reader"] == "kernel_roofline":
            launches[m["wrap"][0]] = TR.load_callable(m["bound"])
        else:
            spans += m.get("wrap", [])
    units = int(cell["traced_units"])
    torch.cuda.reset_peak_memory_stats(device)
    recs = [w.run(units=units)]
    peak = torch.cuda.max_memory_allocated(device)
    plain = TR.profile(lambda: recs.append(w.run(units=units)), device,
                       host=False)
    tracer = TR.Tracer(spans, launches)
    with tracer.installed(device):
        spanned = TR.profile(lambda: recs.append(w.run(units=units)),
                             device, host=True)
    rec = {k: sum(r[k] for r in recs)
           for k in ("attempted", "failed", "dropped_pairs")}
    ctx = Context(units, tracer.resolved_records(), peak,
                  wall_s=recs[0]["window_s"])
    metrics = {}
    for m in cell["per_layer"]:
        reader = importlib.import_module(f"benchmark.readers.{m['reader']}")
        ctx.trace = spanned if m["reader"] in ("span", "kernel_roofline") \
            else plain
        value = reader.read(m, ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    busy_us, _gaps = plain.busy()
    extra = {"device": {"busy_s": busy_us * 1e-6,
                        "window_s": plain.window_us * 1e-6},
             "breakdown": {"device_ops": plain.breakdown()["device_ops"],
                           "idle_gaps": spanned.breakdown()["idle_gaps"]}}
    print(f"traced {units} {w.unit} twice: {plain.window_us * 1e-6:.4f} s "
          f"recording the card, {spanned.window_us * 1e-6:.4f} s recording "
          "the host too", file=sys.stderr)
    return rec, metrics, extra


class Context:
    """What a per-layer reader reads: the parsed trace (``trace``, set per
    metric), the units (frames or steps) a stretch holds, the launch
    records, and the untraced stretch's peak memory and wall seconds."""

    def __init__(self, units, records, peak_bytes, wall_s):
        self.trace, self.units = None, units
        self.records, self.peak_bytes, self.wall_s = (records, peak_bytes,
                                                      wall_s)


def device_line(torch) -> str:
    """The card's name, the cards used, the power limit and the
    toolchain."""
    def query(field):
        try:
            return subprocess.run(
                ["nvidia-smi", f"--query-gpu={field}",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip().splitlines()[0]
        except (OSError, IndexError, subprocess.SubprocessError):
            return "?"

    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    try:
        ver = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
        release = ver.split("release ")[1].split(",")[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        release = "?"
    try:
        from importlib.metadata import version
        triton = f"triton {version('triton')}"
    except Exception:  # noqa: BLE001 - absent or unreadable: say so
        triton = "no triton"
    return (f"device: {torch.cuda.get_device_name(0)} x"
            f"{torch.cuda.device_count()}, power.limit "
            f"{query('power.limit')}, driver {query('driver_version')}, "
            f"nvcc {release}, torch {torch.__version__}, cuda "
            f"{torch.version.cuda}, {triton}")


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that no run may load, compared
    whole (``rtgs_tpu_torch`` is not ``rtgs_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    cell = load_cell(args.workload)

    import torch

    # One intra-op thread: the card does the work and the host only
    # launches it, so the run's load on the machine's shared cores is one
    # thread's, whatever their number. No core is pinned: two runs at once
    # would share the same ones.
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    line = device_line(torch)
    print(line, flush=True)
    print(line, file=sys.stderr, flush=True)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    out["device"] = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                         count=int(cell["chips"]), **out["device"])
    print(f"correct: {out['correct']}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
