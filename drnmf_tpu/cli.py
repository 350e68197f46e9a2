"""Command-line driver.

Reference-compatible invocation (enhance.py:459-475):

    python -m drnmf_tpu.cli -c <model config YAML> -d <data config YAML>

with the model type dispatched by config-filename substring exactly like the
reference ('unfolded_snmf' before 'snmf' before 'lstm', enhance.py:529-538).
Common variants:

    ... --no-score            # train only
    ... --rescore             # recompute cached scores (training cache hits)
    ... --recompute           # redo everything
    ... --no-pesq             # skip PESQ (computed by default)
    ... --trace DIR           # write a jax.profiler trace
"""

import argparse
import os
import sys

from .utils import load_yaml
from . import pipeline


def dispatch_model_type(configfile: str) -> str:
    name = os.path.basename(configfile)
    if "unfolded_snmf" in name:
        return "unfolded_snmf"
    if "snmf" in name:
        return "snmf"
    if "lstm" in name:
        return "lstm"
    raise ValueError(
        f"cannot infer model type from config filename '{configfile}' "
        "(expected a 'unfolded_snmf', 'snmf', or 'lstm' substring)"
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-c", "--config", required=True,
                        help="model config YAML")
    parser.add_argument("-d", "--data", required=True,
                        help="data setup YAML")
    parser.add_argument("--exp-dir", default=None,
                        help="experiment dir (default data_setup_downsample<d>)")
    parser.add_argument("--recompute", action="store_true")
    parser.add_argument("--rescore", action="store_true")
    parser.add_argument("--no-score", action="store_true")
    parser.add_argument("--pesq", action="store_true",
                        help=argparse.SUPPRESS)  # PESQ is on by default now
    parser.add_argument("--no-pesq", action="store_true",
                        help="skip PESQ (on by default, like the reference "
                        "score_audio.m:225; the model is P.862-structured, "
                        "anchor-calibrated, not a bit-exact ITU port)")
    parser.add_argument("--splits", default="valid,test")
    parser.add_argument("--compile-cache", default=None, metavar="DIR",
                        help="persistent XLA compilation cache dir (default: "
                        "$JAX_COMPILATION_CACHE_DIR when set, else "
                        "<checkout>/.jax_cache)")
    parser.add_argument("--no-compile-cache", action="store_true")
    parser.add_argument("--trace", default=None, metavar="DIR",
                        help="write a jax.profiler trace to DIR "
                        "(TensorBoard/Perfetto-viewable)")
    parser.add_argument("--dp", default="auto", metavar="N",
                        help="data-parallel training over N devices "
                        "('auto' = all local devices when more than one, "
                        "'0'/'1' = off)")
    parser.add_argument("--tp", default=0, type=int, metavar="N",
                        help="tensor-parallel recurrence over N devices "
                        "(DR-NMF training only; composes with --dp into a "
                        "2-D dp x tp mesh -- batch over dp, the hidden "
                        "contraction over tp)")
    parser.add_argument("--fsdp", action="store_true",
                        help="shard params + optimizer state over the dp "
                        "axis (ZeRO-3 layout) instead of replicating -- "
                        "per-device HBM for weights/Adam drops ~1/dp; "
                        "numerically the same run (needs --dp > 1)")
    parser.add_argument("-q", "--quiet", action="store_true")
    args = parser.parse_args(argv)

    for path, what in ((args.config, "model config"), (args.data, "data config")):
        if not os.path.isfile(path):
            parser.error(f"{what} not found: {path}")
    params_model = load_yaml(args.config)
    params_data = load_yaml(args.data)
    try:
        model_type = dispatch_model_type(args.config)
    except ValueError as e:
        parser.error(str(e))

    folder_exp = args.exp_dir or (
        "data_setup_downsample%d" % params_data.get("downsample", 1)
    )
    splits = tuple(s for s in args.splits.split(",") if s)
    common = dict(
        flag_recompute=args.recompute,
        flag_score=not args.no_score,
        flag_rescore=args.rescore,
        compute_pesq=not args.no_pesq,
        verbose=not args.quiet,
        splits=splits,
    )

    # data-parallel training mesh ('auto': every local device when the host
    # has more than one -- the SURVEY.md parallelism table's DP row)
    mesh = None
    if args.tp > 1 and model_type != "unfolded_snmf":
        parser.error("--tp applies to the DR-NMF recurrence only")
    if args.fsdp:
        if model_type not in ("unfolded_snmf", "lstm"):
            parser.error("--fsdp applies to trained models only")
        # run control, not model identity: same numbers, different layout
        params_model["fsdp"] = True
    # every family builds the mesh: trained models shard the fit AND the
    # scoring; the snmf branch uses it for mesh-sharded scoring only
    import jax

    n_dev = len(jax.devices())
    n_tp = max(args.tp, 1)
    if args.dp == "auto":
        n_dp = n_dev // n_tp if n_tp > 1 else n_dev
    else:
        n_dp = int(args.dp)
    n_dp = max(n_dp, 1)
    if n_tp > 1:
        if n_dp * n_tp > n_dev:
            parser.error(f"--dp {n_dp} x --tp {n_tp} exceeds "
                         f"{n_dev} local devices")
        from .parallel import make_mesh_2d

        mesh = make_mesh_2d(n_dp, n_tp)
        if not args.quiet:
            print(f"2-D training mesh: dp={n_dp} x tp={n_tp}")
    elif n_dp > 1:
        if n_dp > n_dev:
            parser.error(f"--dp {n_dp} exceeds {n_dev} local devices")
        from .parallel import make_mesh

        mesh = make_mesh(n_dp)
        if not args.quiet:
            print(f"data-parallel mesh over {n_dp} devices")
    if args.fsdp and mesh is None:
        parser.error("--fsdp requires a data-parallel mesh (--dp > 1)")

    # persistent XLA compilation cache: repeated CLI invocations (the grid
    # scripts, rescoring, resumed runs) skip recompiling identical programs
    if not args.no_compile_cache:
        from .utils import enable_compile_cache

        enable_compile_cache(args.compile_cache)

    from .utils import trace

    with trace(args.trace):
        if model_type == "unfolded_snmf":
            pipeline.run_unfolded_snmf(params_model, params_data, folder_exp,
                                       mesh=mesh, **common)
        elif model_type == "lstm":
            pipeline.run_lstm(params_model, params_data, folder_exp,
                              mesh=mesh, **common)
        else:
            pipeline.run_snmf(params_model, params_data, folder_exp,
                              mesh=mesh, **common)


if __name__ == "__main__":
    main(sys.argv[1:])
