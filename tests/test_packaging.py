"""Packaging metadata sanity: the installable surface a reference user gets
(`pip install -e .`) matches the repo — console entry point resolves, the
declared dependencies are the ones the package imports, and the native
loader honors DRNMF_NATIVE_DIR for installed (non-checkout) layouts."""

import importlib
import os
import subprocess
import sys
import tomllib

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _project():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)["project"]


def test_console_entry_point_resolves():
    proj = _project()
    target = proj["scripts"]["drnmf-tpu"]
    mod_name, func_name = target.split(":")
    mod = importlib.import_module(mod_name)
    fn = getattr(mod, func_name)
    assert callable(fn)


def test_declared_dependencies_are_importable():
    proj = _project()
    for dep in proj["dependencies"]:
        name = dep.split("[")[0].split(">")[0].split("=")[0].strip()
        importlib.import_module(name.replace("-", "_"))
    # PyYAML and h5py are optional: the package runs without them
    extras = proj["optional-dependencies"]
    assert extras["yaml"] == ["pyyaml"] and extras["hdf5"] == ["h5py"]


# Blocking a module in sys.modules makes its import raise ImportError, as
# on a machine without it.
_BLOCK = "import sys; sys.modules['yaml'] = None; sys.modules['h5py'] = None; "


def _run_blocked(code):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-c", _BLOCK + code], env=env,
                          capture_output=True, text=True, cwd=REPO,
                          timeout=300)


def test_package_and_cli_import_without_yaml_and_h5py():
    out = _run_blocked(
        "import drnmf_tpu.pipeline, drnmf_tpu.cli; "
        "from drnmf_tpu.cli import main\n"
        "try:\n    main(['--help'])\nexcept SystemExit as e:\n"
        "    print('exit', e.code)")
    assert out.returncode == 0, out.stderr
    assert "exit 0" in out.stdout


def test_chip_smoke_imports_without_yaml_and_h5py():
    """Every module chip_smoke.py's phases import loads without PyYAML and
    h5py, which the machine with the card need not have."""
    out = _run_blocked(
        "import chip_smoke, importlib; "
        "[importlib.import_module(m) for m in ("
        "'drnmf_tpu.data', 'drnmf_tpu.dsp', 'drnmf_tpu.ops', "
        "'drnmf_tpu.reference', 'drnmf_tpu.enhance', 'drnmf_tpu.streaming', "
        "'drnmf_tpu.metrics.engine', 'drnmf_tpu.metrics.sharded', "
        "'drnmf_tpu.parallel', 'drnmf_tpu.train', 'drnmf_tpu.cli', "
        "'drnmf_tpu.data.native_loader')]; chip_smoke._load_serve(); "
        "print('ok')")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_yaml_config_roundtrip_without_pyyaml(tmp_path, monkeypatch):
    """Without PyYAML, dump_yaml writes JSON (valid YAML) that load_yaml
    reads back; a config that is not JSON names the missing package."""
    from drnmf_tpu.utils import dump_yaml, load_yaml

    monkeypatch.setitem(sys.modules, "yaml", None)
    cfg = {"K_layers": 5, "r": 1000, "alph": 400.0,
           "params_untied": ["log_D", "log_alph"], "params_stft": {"N": 512}}
    path = str(tmp_path / "params_unfolded_snmf_x.yaml")
    dump_yaml(cfg, path)
    assert load_yaml(path) == cfg
    plain = tmp_path / "plain.yaml"
    plain.write_text("K_layers: 5\nr: 1000\n")
    with pytest.raises(ImportError, match="pyyaml"):
        load_yaml(str(plain))


def test_packages_find_covers_all_subpackages():
    from setuptools import find_packages

    found = set(find_packages(where=REPO, include=["drnmf_tpu*"]))
    on_disk = {"drnmf_tpu"}
    for root, dirs, files in os.walk(os.path.join(REPO, "drnmf_tpu")):
        if "__init__.py" in files:
            rel = os.path.relpath(root, REPO).replace(os.sep, ".")
            on_disk.add(rel)
    assert found == on_disk


def test_native_dir_env_override(tmp_path):
    # A fresh interpreter with DRNMF_NATIVE_DIR pointing at an empty dir must
    # resolve the .so path there (and so report the fast path unavailable,
    # falling back to scipy) without touching the checkout's native/.
    code = (
        "import os; from drnmf_tpu.data import native_loader as nl; "
        "print(os.path.dirname(nl._SO_PATH))"
    )
    env = dict(os.environ, DRNMF_NATIVE_DIR=str(tmp_path), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, check=True, cwd=REPO,
    )
    assert out.stdout.strip() == str(tmp_path)
