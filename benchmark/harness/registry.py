"""Finds the benchmark's parts by name: a cell in ``BENCHMARK.json``, a
configuration in ``configs/<name>.json``, a traffic mix in
``traffic/<name>.json``, a metric's reader in ``metrics/<name>.py`` and
a configuration's plain reference in ``reference/<module>.py``.  A later
change adds a part by adding its file and its entry; nothing here lists
them."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

#: the benchmark's folder and the checkout's root
BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_benchmark(path=None):
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError("no workload %r in BENCHMARK.json (have: %s)"
                   % (name, ", ".join(w["name"] for w in bench["workloads"])))


def _json(kind, name):
    path = BENCH / kind / (name + ".json")
    if not path.is_file():
        raise KeyError("no %s file %s" % (kind, path))
    with open(path) as f:
        return json.load(f)


def config(name):
    return _json("configs", name)


def traffic(name):
    return _json("traffic", name)


def _module(path, label):
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name):
    """The ``read(record)`` function of the metric ``name``: the reader
    ``metrics/<name>.py``, or, for a quantity split by the cells that
    report it (``<base>.<part>``, as ``ms_per_krylov_it.2d``), the reader
    ``metrics/<base>.py`` where the split name has none of its own."""
    for stem in dict.fromkeys((name, name.split(".")[0])):
        path = BENCH / "metrics" / (stem + ".py")
        if path.is_file():
            return _module(path, "benchmark_metric_"
                           + stem.replace(".", "_")).read
    raise KeyError("no reader metrics/%s.py for metric %r" % (name, name))


def reference(module):
    """The plain reference module ``reference/<module>.py``."""
    path = BENCH / "reference" / (module + ".py")
    if not path.is_file():
        raise KeyError("no reference %s" % path)
    return _module(path, "benchmark_reference_" + module)
