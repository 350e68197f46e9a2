"""Config system: YAML configs + md5-of-sorted-json artifact hashing.

PyYAML is optional: without it configs are written as JSON, which is valid
YAML, and JSON-formatted configs still load.

Reproduces the reference's experiment registry (enhance.py:60-78, 679-714):
every artifact (dictionary, model, history, scores) is named by the md5 hash
of its sorted-JSON config, so reruns are idempotent and configs are
self-documenting.  Numpy scalars/arrays are JSON-encoded like the reference's
``MyEncoder``.
"""

import hashlib
import json
import os

import numpy as np


class _NumpyEncoder(json.JSONEncoder):
    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return super().default(obj)


def config_hash(config: dict, exclude=()) -> str:
    cfg = {k: v for k, v in config.items() if k not in exclude}
    return hashlib.md5(
        json.dumps(cfg, sort_keys=True, cls=_NumpyEncoder).encode()
    ).hexdigest()


def load_yaml(path):
    """Read a YAML config with PyYAML; without PyYAML, read it as JSON
    (JSON is valid YAML, and :func:`dump_yaml` writes JSON then)."""
    with open(path) as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        try:
            return json.loads(text)
        except json.JSONDecodeError as e:
            raise ImportError(
                f"{path} is not JSON and PyYAML is not installed; install "
                "pyyaml (pip install 'drnmf-tpu[yaml]') to read it") from e
    return yaml.safe_load(text)


def dump_yaml(obj, path):
    """Write a config as YAML, or as JSON (valid YAML) without PyYAML."""
    try:
        import yaml
    except ImportError:
        yaml = None
    with open(path, "w") as f:
        if yaml is None:
            json.dump(obj, f, indent=1, sort_keys=True, cls=_NumpyEncoder)
        else:
            yaml.safe_dump(obj, f)


def ensure_experiment_dirs(folder_exp):
    """Create the experiment folder layout (enhance.py:709-713)."""
    for sub in ("configs", "history", "models", "scores"):
        os.makedirs(os.path.join(folder_exp, sub), exist_ok=True)
    return folder_exp
