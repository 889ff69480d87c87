"""The benchmark of alfi_torch on CUDA cards: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  It prints the card's name and power limit
and, as the last lines on standard error, each number the check compares
with its limit; the last line on standard output is the result, one JSON
object.  Without a CUDA card, or with fewer than the cell asks for, it
exits with code 2 and prints no result.  See README.md beside this file.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
#: build and kernel caches at fixed paths inside the checkout, so that only
#: a checkout's first run builds (the port's own kernels build into
#: alfi_torch/_build/ beside its sources)
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, os.path.join(_ROOT, ".bench_cache", _sub))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

#: modules that may not be loaded in the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "alfi_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    from benchmark.harness import cell, device, registry

    bench = registry.load_benchmark()
    w = registry.workload(bench, a.workload)
    device.require_cards(int(w["chips"]))
    import torch

    print("card: %s (nvidia-smi: %s); torch %s, CUDA %s"
          % (torch.cuda.get_device_name(0), device.power_limit(),
             torch.__version__, torch.version.cuda), file=sys.stderr,
          flush=True)
    result = cell.run(bench, a.workload, a.seed, a.seconds, bool(a.trace),
                      t_start=T_START)
    found = forbidden_modules()
    if found:
        print("benchmark: the process loaded %s; no result"
              % ", ".join(found), file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
