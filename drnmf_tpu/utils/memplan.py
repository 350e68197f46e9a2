"""Static per-device HBM planning for DR-NMF training layouts.

The reference never needed this (single GPU, r<=1000 fits anywhere:
enhance.py:147, run_waspaa2017.sh grid).  The question "does this
dictionary size train on this mesh?" is answerable in closed form BEFORE
claiming devices: parameter shapes follow ``init_drnmf_params`` exactly
(pinned by test), Adam keeps two moments per TRAINABLE tensor
(``train/losses.py`` optimizer via optax.multi_transform -- frozen params
carry no optimizer state), and the FSDP layout divides every tensor whose
largest dp-divisible dimension was sharded (``parallel/mesh.py::
fsdp_param_sharding`` rule, reproduced here shape-for-shape).

Example (the reason --fsdp exists): the flagship K=5 untied-D model at
10x the paper's dictionary (r=10_000, F=257) holds 3.3 GB of params +
Adam state, 3.0 GB of it the two frozen (2r, 2r) U tensors; under FSDP
on dp=8 the per-device total drops to 426 MB.  At 2r=50k the U tensors
alone are ~20 GB, and the whole model then trains only with this layout
once activations and Adam state are counted on top.

Usage:
    python -m drnmf_tpu.utils.memplan -c params_unfolded_snmf.yaml \
        --input-dim 257 --dp 8 --fsdp
"""

from __future__ import annotations

import numpy as np


def drnmf_param_shapes(config) -> dict:
    """Parameter-name -> shape map, mirroring ``init_drnmf_params``
    (models/drnmf.py:115-161) without materializing any array."""
    n2r = config.hidden_dim
    f = config.input_dim
    shapes = {
        "log_U1": (n2r, n2r),
        "log_Uk": (n2r, n2r),
        "log_W_clean": (config.r, f),
        "log_W_noise": (n2r - config.r, f),
    }
    shapes["log_h0" if config.nonnegative else "h0"] = (n2r,)
    base = {
        "log_D": (f, n2r),
        "log_alph": (n2r,) if config.untie_alph else (),
        "log_lam1": (),
    }
    for name, shape in base.items():
        if name in config.params_untied:
            for k in range(config.K_layers):
                shapes[f"{name}_{k}"] = shape
        else:
            shapes[name] = shape
    return shapes


def _fsdp_local_elems(shape, n_dp, min_elems):
    """Per-device element count under the FSDP placement rule
    (``parallel/mesh.py::fsdp_param_sharding``): the largest dp-divisible
    dimension shards; otherwise the tensor replicates."""
    total = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if n_dp <= 1 or total < min_elems:
        return total
    cands = [d for d in range(len(shape)) if shape[d] % n_dp == 0]
    if not cands:
        return total
    return total // n_dp


def plan_memory(config, n_dp=1, fsdp=False, min_elems=1 << 16,
                dtype_bytes=4):
    """Per-device training-memory plan (bytes).

    Returns a dict with ``params``, ``opt_state`` (two Adam moments per
    trainable tensor), ``total``, and per-tensor detail.  ``fsdp=False``
    models the replicated layout (every device holds everything);
    ``fsdp=True`` applies the dp-sharding rule to params AND moments
    (``train/loop.py`` places both by the same shape-based rule).
    """
    from ..models.drnmf import drnmf_trainable_mask

    shapes = drnmf_param_shapes(config)
    trainable = drnmf_trainable_mask(config, shapes)
    detail = {}
    p_bytes = o_bytes = 0
    for name, shape in shapes.items():
        local = (_fsdp_local_elems(shape, n_dp, min_elems) if fsdp
                 else int(np.prod(shape, dtype=np.int64)) if shape else 1)
        pb = local * dtype_bytes
        ob = 2 * pb if trainable[name] else 0
        detail[name] = {"shape": shape, "param_bytes": pb,
                        "moment_bytes": ob, "trainable": trainable[name]}
        p_bytes += pb
        o_bytes += ob
    return {"params": p_bytes, "opt_state": o_bytes,
            "total": p_bytes + o_bytes, "per_tensor": detail,
            "layout": "fsdp" if fsdp else "replicated", "n_dp": n_dp}


def _fmt(b):
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if b < 1024 or unit == "TB":
            return f"{b:.1f} {unit}" if unit != "B" else f"{b} B"
        b /= 1024


def main(argv=None):
    import argparse

    from ..pipeline import drnmf_config_from_params
    from . import load_yaml

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-c", "--config", required=True,
                    help="model YAML (params_unfolded_snmf_*.yaml)")
    ap.add_argument("--input-dim", type=int, default=257,
                    help="F = n_fft//2 + 1 (default 257: N=512)")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--fsdp", action="store_true")
    args = ap.parse_args(argv)

    config = drnmf_config_from_params(load_yaml(args.config), args.input_dim)
    plan = plan_memory(config, n_dp=args.dp, fsdp=args.fsdp)
    print(f"layout={plan['layout']} dp={plan['n_dp']} "
          f"(K={config.K_layers}, 2r={config.hidden_dim}, "
          f"F={config.input_dim})")
    for name, d in sorted(plan["per_tensor"].items(),
                          key=lambda kv: -kv[1]["param_bytes"]):
        t = "train" if d["trainable"] else "frozen"
        print(f"  {name:16s} {str(d['shape']):16s} {t}  "
              f"param {_fmt(d['param_bytes']):>10s}  "
              f"adam {_fmt(d['moment_bytes']):>10s}")
    print(f"per-device params    : {_fmt(plan['params'])}")
    print(f"per-device opt state : {_fmt(plan['opt_state'])}")
    print(f"per-device total     : {_fmt(plan['total'])}")


if __name__ == "__main__":
    main()
