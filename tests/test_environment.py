"""What the program needs from its installation: where the compile cache
lives, that chip_smoke.py refuses to run without a GPU or without the
repository, that model building needs no PyYAML, and that the sharded
multi-device step runs on a virtual CPU mesh."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).parent.parent


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_COMPILATION_CACHE_DIR")}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


def _python(code, cwd, **env):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          env=_env(PYTHONPATH=str(REPO), **env),
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(tmp_path, env_set):
    extra = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cc")} \
        if env_set else {}
    r = _python("import jax\n"
                "from iqtree2_tpu.utils.compilecache import "
                "enable_compile_cache\n"
                "print(enable_compile_cache())\n"
                "print(jax.config.jax_compilation_cache_dir)\n",
                tmp_path, **extra)
    assert r.returncode == 0, r.stderr[-2000:]
    want = str(tmp_path / "cc") if env_set else str(REPO / ".jax_cache")
    assert r.stdout.split() == [want, want]
    assert Path(want).is_dir()


def _assert_refused(r):
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_refuses_cpu_backend(tmp_path):
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       cwd=tmp_path, env=_env(), capture_output=True,
                       text=True, timeout=300)
    _assert_refused(r)
    assert "no GPU" in r.stderr


def test_chip_smoke_refuses_without_repository(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
    _assert_refused(r)
    assert "ModuleNotFoundError" in r.stderr


NO_YAML = "import sys\nsys.modules['yaml'] = None\n"


def test_model_build_without_yaml(tmp_path):
    r = _python(NO_YAML +
                "from iqtree2_tpu.io.alignment_io import read_alignment\n"
                "from iqtree2_tpu.model.factory import build_model\n"
                f"aln = read_alignment({str(REPO / 'tests/golden/example.phy')!r})\n"
                "model, rates, _ = build_model('GTR+G', aln)\n"
                "print(type(model).__name__, rates.ncat)\n", tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["GTRModel", "4"]


def test_mdef_without_yaml_names_the_module(tmp_path):
    (tmp_path / "m.yaml").write_text("- model: X\n")
    r = _python(NO_YAML +
                "from iqtree2_tpu.io.yamlmodels import load_definitions\n"
                "try:\n"
                "    load_definitions('m.yaml')\n"
                "except ImportError as e:\n"
                "    print('refused:', e)\n", tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("refused:") and "PyYAML" in r.stdout


def test_dryrun_multichip_on_virtual_devices():
    import __graft_entry__ as graft
    r = graft.dryrun_multichip(4, ntaxa=20, npat=700, max_nni=16)
    assert r["n_devices"] == 4 and r["patterns"] % (4 * 128) == 0
    assert r["blens_diff"] <= 5e-3
