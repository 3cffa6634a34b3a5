"""Run one cell of the benchmark and print its result as the last line.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. Exits non-zero, with no result line, when CUDA is unavailable or there
are fewer cards than the cell asks for, and when a module of JAX or of the
JAX package is loaded as the result is about to be printed (after the
window, the check and the per-layer readers). The numbers the check
compared are printed with their limits as the last lines on standard error,
and under ``checks`` as the result line's last key.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``), 0 elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None, root: str = ROOT, device: str = "cuda") -> int:
    """``root`` and ``device`` are for the benchmark's own tests, which run a
    tiny cell on the CPU."""
    age = _process_age_s()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, ROOT)
    # the kernels' CUDA driver cache, at a fixed place in the checkout
    os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(ROOT, ".cache", "cuda"))
    from h100_bench import cell, spec

    chips = spec.cell(args.workload, root).chips
    import torch
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    res = cell.run(args.workload, args.seed, args.seconds, bool(args.trace),
                   device=device, process_age_s=age, t_start=_T0, root=root)
    window = res.pop("_window")
    found = cell.forbidden_modules()
    if found:
        print(f"modules the port may not load are loaded: {found}", file=sys.stderr)
        return 3
    print(f"window: {json.dumps(window)}", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
