"""Finding a cell's parts by name. A cell is an entry of ``workloads`` in
``BENCHMARK.json`` that names a configuration and a traffic mix; each part
is a file of its own under this directory, found by that name:

- ``configs/<config>.json``: the deployment (the generator's settings that
  the configuration fixes, batch size and prefetch among them, its texture
  bank, its source);
- ``traffic/<traffic>.json``: the mix (the settings it adds, such as the
  photometric jitter, the warm-up, the window's profiled steps, the rows
  the check compares);
- ``limits/<cell>.json``: the limit of each number the check compares;
- ``metrics/<metric>.py``: the reader of one per-layer metric, a
  ``read(record)`` function that returns a number or None;
- ``reference/<name>.py``, the module ``perfbench.reference.<name>``: the
  plain reference that renders a configuration, named by its
  ``reference`` key (``rigid`` without one).

A later cell, configuration, mix or metric is added as new files and new
entries, with no file here edited.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
# What every reference module exposes (``reference/__init__.py``).
REFERENCE_API = ("check_supported", "render_rows")


def _checked(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of the benchmark with its configuration, traffic mix,
    limits and metric entries, read from ``base`` (this directory unless a
    test gives another) and ``benchmark`` (``BENCHMARK.json``)."""

    def __init__(self, name: str, benchmark: Path = BENCHMARK,
                 base: Path = HERE):
        self.base = Path(base)
        self.bench = load_json(Path(benchmark))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in {benchmark}")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        self.config = load_json(
            self.base / "configs" / f"{_checked(self.entry['config'])}.json")
        self.traffic = load_json(
            self.base / "traffic" / f"{_checked(self.entry['traffic'])}.json")
        self.limits = load_json(self.base / "limits" / f"{_checked(name)}.json")
        self.reference()

    def generator_settings(self, seed: int) -> dict:
        """The program's configuration values by name: the configuration's,
        then the mix's, and the run's seed."""
        out = dict(self.config["generator"])
        out.update(self.traffic.get("generator", {}))
        out["batch_size"] = int(out["batch_size"])
        out["seed"] = int(seed) % 2**32
        return out

    def _metrics(self, section: str):
        return [m for m in self.bench[section]
                if self.name in m.get("workloads", [self.name])]

    def end_to_end(self):
        """This cell's end-to-end metric entries."""
        return self._metrics("end_to_end")

    def per_layer(self):
        """This cell's per-layer metric entries."""
        return self._metrics("per_layer")

    def reference(self):
        """The module ``perfbench.reference.<name>`` that the configuration's
        ``reference`` key names (``rigid`` without one). Raises
        ``ValueError`` where there is no such module or it lacks one of
        :data:`REFERENCE_API`."""
        name = _checked(self.config.get("reference", "rigid"))
        full = f"perfbench.reference.{name}"
        try:
            mod = importlib.import_module(full)
        except ModuleNotFoundError as e:
            if e.name != full and not full.startswith(f"{e.name}."):
                raise
            raise ValueError(f"configuration {self.config.get('name')!r}: no "
                             f"reference module {full}") from e
        missing = [f for f in REFERENCE_API
                   if not callable(getattr(mod, f, None))]
        if missing:
            raise ValueError(f"reference module {full} lacks {missing}")
        return mod

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = self.base / "metrics" / f"{_checked(metric)}.py"
        spec = importlib.util.spec_from_file_location(
            f"perfbench_metric_{metric.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
