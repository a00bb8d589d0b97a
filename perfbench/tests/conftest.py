"""Shared fixtures of the benchmark's own tests (CPU, small sizes)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

PERFBENCH = Path(__file__).resolve().parent.parent
CHECKOUT = PERFBENCH.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

# Small cells for the CPU: the chairs configuration at 128x96 (the scene
# kernel's plain version) and at 136x100, a frame that is no multiple of 8
# (the windowed renderer), B=4, prefetch 2, four textures.
TINY = {"tiny_chairs": ("chairs_m7", 128, 96),
        "tiny_windowed": ("chairs_m7", 136, 100)}


@pytest.fixture
def tiny_bench(tmp_path):
    """A copy of the benchmark's data files in ``tmp_path/perfbench`` plus
    small cells ``tiny_chairs.t``, ``tiny_chairs.t_photo`` and
    ``tiny_windowed.t``; returns (BENCHMARK.json path, base directory)."""
    base = tmp_path / "perfbench"
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(PERFBENCH / d, base / d)
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    for name, (src, w, h) in TINY.items():
        cfg = json.loads((base / "configs" / f"{src}.json").read_text())
        cfg["name"] = name
        cfg["generator"].update(width=w, height=h, batch_size=4, prefetch=2)
        cfg["atlas"]["textures"] = 4
        (base / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for src, dst in (("trainer", "t"), ("trainer_photo", "t_photo")):
        t = json.loads((base / "traffic" / f"{src}.json").read_text())
        t.update(name=dst, compare_rows=3, profile_steps=2)
        (base / "traffic" / f"{dst}.json").write_text(json.dumps(t))
    cells = [("tiny_chairs.t", "tiny_chairs", "t"),
             ("tiny_chairs.t_photo", "tiny_chairs", "t_photo"),
             ("tiny_windowed.t", "tiny_windowed", "t")]
    for name, cfg, traffic in cells:
        bench["workloads"].append({"name": name, "config": cfg,
                                   "traffic": traffic, "chips": 1,
                                   "why": "a small cell for the CPU tests"})
        src = "chairs_m7.trainer_photo" if traffic == "t_photo" \
            else "chairs_m7.trainer"
        shutil.copy(base / "limits" / f"{src}.json",
                    base / "limits" / f"{name}.json")
    for m in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] += [c[0] for c in cells]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path, base
