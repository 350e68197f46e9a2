"""Model checkpointing.

Equivalent of the reference's Keras ``ModelCheckpoint(save_best_only=True,
save_weights_only=True)`` HDF5 files (enhance.py:1135).  Parameters are flat
dicts of arrays, stored as ``.npz`` with the key set preserved; a best-only
policy lives in the training loop.
"""

import os

import numpy as np


def save_checkpoint(path, params, meta=None):
    arrays = {k: np.asarray(v) for k, v in params.items()}
    if meta:
        for k, v in meta.items():
            arrays[f"__meta_{k}"] = np.asarray(v)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def load_checkpoint(path):
    if not path.endswith(".npz"):
        path = path + ".npz"
    data = np.load(path)
    params = {k: data[k] for k in data.files if not k.startswith("__meta_")}
    meta = {
        k[len("__meta_"):]: data[k] for k in data.files if k.startswith("__meta_")
    }
    return params, meta


# -- orbax backend (sharded / multi-host checkpoints) ------------------------

def save_checkpoint_orbax(path, params, meta=None):
    """Orbax checkpoint of a parameter pytree (SURVEY.md section 5: the
    replacement for Keras HDF5 weights when parameters are sharded
    jax.Arrays -- orbax writes each shard from its owning host)."""
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, {"params": dict(params), "meta": dict(meta or {})},
               force=True)
    ckptr.wait_until_finished()


def load_checkpoint_orbax(path):
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    restored = ckptr.restore(os.path.abspath(path))
    return restored["params"], restored.get("meta", {})
