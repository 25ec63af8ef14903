"""The benchmark of the PyTorch and CUDA port (`ssvio_tpu_torch`): one run
of one cell of `BENCHMARK.json` on the card it is started on.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the run's numbers on earlier lines and, as the last line of
standard output, one JSON object: correct, attempted (frames), failed
(frames the port reported LOST), metrics (the cell's end-to-end metrics
with --trace 0, its per-layer metrics with --trace 1), device, with
--trace 1 a breakdown of the traced slice, and last `checks`: each
number the correctness check compared, with its limit (also the last
lines of standard error).

Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), in a checkout without the port, and when a JAX
module or the JAX package is loaded once the window has closed. Builds
and kernel caches stay inside the checkout (`build/`).
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()     # set-up starts here

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "ssvio_tpu")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    """The loaded modules whose top-level name is one of FORBIDDEN,
    compared whole (`ssvio_tpu_torch` is not `ssvio_tpu`)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def load_reader(name: str):
    """The reader of the per-layer metric `name`:
    benchmark/metrics/<name>.py, which defines read(run)."""
    path = os.path.join(ROOT, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def require_cards(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("benchmark: no CUDA device")
    if torch.cuda.device_count() < chips:
        sys.exit(f"benchmark: the cell asks for {chips} cards, "
                 f"{torch.cuda.device_count()} are here")


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own nvcc cache is build/ssvio_tpu_torch/, fixed in
    code)."""
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")


def card_name() -> str:
    import torch
    return torch.cuda.get_device_name(0)


def set_up(cell, args, device):
    """The System, the drive and the warm-up. Returns (system, drive,
    mode class, warm-up frames)."""
    from benchmark import cells, harness, traffic
    from ssvio_tpu_torch.system import System
    s = cells.settings_from(cell.config)
    tr = cell.traffic
    sys_ = System(s, enable_backend=s.backend_open,
                  enable_loop_closing=s.loop_closing_open, device=device)
    drive = traffic.make_drive(tr["drive"], args.seed, s, sys_.w, sys_.h,
                               device)
    mode_cls, warmup = harness.MODES[tr["mode"]]
    n_warm = warmup(sys_, drive, tr, len(drive.left))
    return sys_, drive, mode_cls, n_warm


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def execute(cell, args, device) -> dict:
    """Set-up, window, traced slice, judgement and metrics of one run on
    `device`. Returns the result line as a dict."""
    import torch
    from benchmark import harness, judge as judging, spans as spanmod
    with torch.no_grad():
        sys_, drive, mode_cls, n_warm = set_up(cell, args, device)
        s = sys_.s
        run = harness.Run(cell.traffic["mode"], s, (sys_.h, sys_.w))
        spans = spanmod.Spans(annotate=bool(args.trace)) if args.trace \
            else None
        run.spans = spans
        harness._wrap(spans, sys_, run.mode)
        judge = judging.Judge(s, args.seed, s.baseline)
        mode = mode_cls(sys_, drive, cell.traffic, run, judge, spans)
        _sync(device)
        setup_s = time.perf_counter() - T_PROCESS
        mode.window(args.seconds)
        _sync(device)
        if args.trace:
            mode.traced_slice()
        mode.close()
        memory_peak = (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else 0)
        loops = run.loops + sys_.stats["n_loops"]
        sys_.close()
        del mode, sys_, drive
        if device.type == "cuda":
            torch.cuda.empty_cache()
        numbers = judge.evaluate()
    correct, checks = judging.verdict(numbers, cell.limits)

    print(json.dumps({"frames": run.frames, "window_s": run.seconds,
                      "drives_done": run.drives, "warmup_frames": n_warm,
                      "frame_ate_m": numbers.get("frame_ate_m", []),
                      "rpe1_m": numbers.get("rpe1_m"),
                      "loop_corrections": loops,
                      "samples": {"track": numbers.get("n_track", 0),
                                  "windows": numbers.get("n_windows", 0),
                                  "rpe_pairs": numbers.get("n_rpe", 0)},
                      "widest_track_gap": numbers.get("track_gap"),
                      "ba_gap_median": numbers.get("ba_gap_median")}),
          flush=True)
    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            value = load_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(setup_s=setup_s)
        if run.mode == "offline":
            values["fps"] = run.frames / run.seconds
        else:
            from benchmark import stats
            lat = [r["latency_ms"] for r in run.live]
            values["latency_p50_ms"] = stats.percentile(lat, 50)
            values["latency_p95_ms"] = stats.percentile(lat, 95)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    device_info = {"platform": "gpu", "kind": card_name(),
                   "count": int(cell.workload["chips"]),
                   "memory_peak_bytes": int(memory_peak)}
    out = {"correct": bool(correct), "attempted": run.frames,
           "failed": run.lost, "metrics": metrics, "device": device_info}
    if args.trace:
        from benchmark import tracing
        device_info["busy_s"] = run.slice.busy_s
        device_info["window_s"] = run.slice.window_s
        out["breakdown"] = tracing.breakdown(run.slice)
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, value, limit in checks}
    return out


def the_card():
    import torch
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    return device


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, ROOT)
    from benchmark import cells
    cell = cells.load(args.workload, root=ROOT)
    require_cards(int(cell.workload["chips"]))
    cache_dirs()
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False   # as the config states
    torch.backends.cudnn.allow_tf32 = False
    out = execute(cell, args, the_card())
    # last, after the judgement, the metric readers and the breakdown
    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded after the window: {found}",
              file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
