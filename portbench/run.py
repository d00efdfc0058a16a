"""Run one cell of BENCHMARK.json once, in a process of its own, and print
its result as the last line of standard output.

    python3 portbench/run.py --workload train-b16-b256 --seed 7 --seconds 30 --trace 0

Set-up draws the weights and the inputs from the seed on the card, builds
the system under test (the port, `segclip_tpu_torch`) and warms the cell's
own shapes; then the window runs for --seconds. --trace 0 reports the
cell's end-to-end metrics, --trace 1 its per-layer metrics from profiled
stretches of the window (lib/trace.py). After the window the program is freed and the plain
reference (portbench/reference) checks what the timed path produced; each
number compared is printed beside its limit, last on standard error and
last in the result line. Exits non-zero, printing no result, without
enough CUDA cards, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:           # run as a script from the checkout's root
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "segclip_tpu")


def use_checkout_caches() -> None:
    """Every compile cache at a fixed path inside the checkout, so that only
    a cell's first run there builds (the port's own kernels build into
    build/kernels/ at the checkout's root). Called before torch is
    imported."""
    cache = ROOT / "build" / "portbench-cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def loaded_forbidden() -> list:
    """Top-level names in sys.modules that are JAX's or the JAX package's,
    compared whole (segclip_tpu_torch is not segclip_tpu)."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cell_kinds():
    from portbench.lib.pretrain import PretrainCell
    from portbench.lib.zeroshot import ZeroShotCell
    return {c.kind: c for c in (PretrainCell, ZeroShotCell)}


def run(args, root: Path = ROOT, device=None, fault=None) -> dict:
    """One run; returns the result line. `device` None means the card, as a
    run takes it; a test passes the CPU (and may plant a fault)."""
    import torch
    from portbench.lib import judge, manifest
    cell = manifest.cell(args.workload, root)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"{args.workload} needs {cell.chips} CUDA card(s); "
                             f"this machine has {torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    runner = cell_kinds()[cell.traffic["kind"]](cell, args.seed, device, fault)
    runner.setup()
    on_card = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    setup_s = time.perf_counter() - _T0
    out = runner.window(args.seconds, bool(args.trace))
    peak = max(setup_peak, out["window_peak_bytes"])
    runner.release()
    numbers = runner.numbers()
    found = loaded_forbidden()
    if found:
        raise SystemExit(f"the run loaded {found}: the benchmark measures the port alone")

    metrics = {}
    if args.trace:
        ctx = out["ctx"]
        for m in cell.per_layer:
            value = manifest.reader(m["name"], root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["end_to_end"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": judge.verdict(numbers, cell.limits), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    summary = out["ctx"]["summary"] if args.trace else None
    if summary is not None:
        dev["busy_s"], dev["window_s"] = summary.busy_s, summary.window_s
        line["breakdown"] = {"device_ops": summary.top_ops(),
                             "idle_gaps": out["ctx"]["host_summary"].idle_gaps()}
    line["checks"] = {k: {"value": finite(numbers[k]), "limit": cell.limits.get(k)}
                      for k in numbers}
    return line


def finite(x: float):
    """A number JSON can carry; a reading that is not finite as its text."""
    return x if x == x and abs(x) != float("inf") else str(x)


def main(argv=None) -> int:
    use_checkout_caches()
    line = run(parse(argv))
    for name, check in line["checks"].items():
        print(f"check {name} = {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
