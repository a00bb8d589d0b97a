"""``tools/torch_kernel_counts.py`` runs on the card unless it is given
``--cpu``: without a card and without that flag it exits non-zero and
prints no count."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_kernel_counts_refuses_the_cpu_unless_asked():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "torch_kernel_counts.py"),
         "--one", ".", "7"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr
    assert r.stdout == ""
