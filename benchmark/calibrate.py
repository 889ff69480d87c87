"""The readings that a cell's check limits are set from, at the cell's own
size on the card: in one process, one sweep for each of many seeds (the
window's own path), then every state judged by the plain reference, and
beside it the control and the faults on the same states:

* ``program``: the states as the program returned them (the lower
  reading is their largest ``residual_max`` over the seeds);
* ``control_float32``: each state rounded to float32, the precision below
  the configuration's float64 (its smallest reading is the upper one);
* ``state_unchanged``: each step's answer taken as the state it started
  from;
* ``answer_altered``: each state with one interior velocity dof moved by
  1e-4.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--out calibrate.json]

It needs a card, as run.py does, and is not run by the benchmark's runs.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def readings(judge, nodes, steps):
    """{variant: [(re, residual)]} for the program, the control and the
    faults on the steps [(re, u, p)] of one sweep."""
    import torch

    ux = torch.as_tensor(nodes[0])
    k = int(((ux - ux.mean(0)) ** 2).sum(1).argmin())

    def altered(u):
        u = u.clone()
        u[k, 0] += 1e-4
        return u

    prev = [None] + steps[:-1]
    variants = {
        "program": steps,
        "control_float32": [(re, u.float().double(), p.float().double())
                            for re, u, p in steps],
        "state_unchanged": [(re, q[1], q[2]) for (re, _, _), q in
                            zip(steps, prev) if q is not None],
        "answer_altered": [(re, altered(u), p) for re, u, p in steps],
    }
    return {name: [[re, r] for (re, _, _), r in zip(st, judge.residuals(st))]
            for name, st in variants.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)

    import torch

    from benchmark.harness import device, registry, traffic
    from benchmark.harness.cell import build, free, run_window
    from benchmark.harness.check import Judge

    bench = registry.load_benchmark()
    w = registry.workload(bench, a.workload)
    device.require_cards(int(w["chips"]))
    print("card: %s (nvidia-smi: %s)" % (torch.cuda.get_device_name(0),
                                        device.power_limit()),
          file=sys.stderr, flush=True)
    config = registry.config(w["config"])
    mix = registry.traffic(w["traffic"])
    dev = device.Device("cuda")
    system, mesh, nodes = build(config, mix, "cuda", T_START)
    dev.reset_peak()
    seeds = [int(s) for s in a.seeds.split(",")]
    runs = {}
    for seed in seeds:
        rec, window_s, _, states = run_window(
            system, dev, traffic.sweeps(mix, seed), 0.0)
        runs[seed] = {"sweep_s": window_s, "states": states,
                      "krylov": rec[0]["krylov"], "newton": rec[0]["newton"],
                      "converged": rec[0]["converged"]}
        print("seed %d: sweep %.3f s, Krylov %s, Newton %s"
              % (seed, window_s, rec[0]["krylov"], rec[0]["newton"]),
              file=sys.stderr, flush=True)
    dev.sync()
    peak = dev.peak_bytes()
    print("peak over the sweeps: %d bytes" % peak, file=sys.stderr,
          flush=True)
    free(system, dev)
    del system
    judge = Judge(config, mesh, nodes, "cuda")
    if judge.error:
        raise SystemExit("calibrate: %s" % judge.error)
    result = {"workload": a.workload, "card": torch.cuda.get_device_name(0),
              "power": device.power_limit(), "peak_bytes": peak, "seeds": {}}
    for seed, r in runs.items():
        rd = readings(judge, nodes, r.pop("states"))
        r.update(rd)
        result["seeds"][seed] = r
        print(json.dumps({"seed": seed, **{
            k: max(x for _, x in v) for k, v in rd.items()},
            "min": {k: min(x for _, x in v) for k, v in rd.items()}}),
            flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
