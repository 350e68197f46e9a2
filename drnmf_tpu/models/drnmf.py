"""DR-NMF: deep recurrent NMF by unfolding iterative soft-thresholding.

JAX reimplementation of the reference's model stack:

* the ``SimpleDeepRNN`` recurrent cell (reference custom_layers.py:104-412),
  whose step runs a K-layer-deep unfolded-ISTA stack,
* the SNMF->RNN "alternate parameter" reparameterization ``build_alt``
  (reference enhance.py:139-206),
* the ``DenseNonNegW`` exp-kernel reconstruction heads and the numerically
  stable A/(A+B) Wiener-style ratio-mask merge
  (reference custom_layers.py:15-56, enhance.py:209-317).

Architecture (per timestep t, previous top-layer state h_{t-1}):

    layer k:  pre_k = h_{t-1} @ U_k  (+ hidden_{k-1} @ S_k for k>0)  + x_t @ W_k
              hidden_k = relu(pre_k + b_k)
    with  U_1 = exp(log_U1)^T (~= I at init),  U_{k>1} = exp(log_Uk)^T (~= 0),
          S_k = (I - Dhat_k^T Dhat_k / alph_k)^T,   W_k = Dhat_k / alph_k,
          b_k = -lam1_k / alph_k,
          Dhat = column-L2-normalized exp(log_D)

i.e. one warm-started ISTA pass ``h <- max(0, h + Dhat^T (x - Dhat h)/alph -
lam1/alph)`` unrolled K deep (cf. reference ista_ed, enhance.py:402-418).

Design:

* Parameters are a flat dict pytree of *alternate* (log-domain) tensors; the
  effective per-layer matrices are materialized ONCE per forward pass
  (outside the time scan) and the time recurrence is a single ``lax.scan`` --
  arbitrary sequence length without graph rebuilds (the reference had to
  rebuild its Theano graph per maxseq, enhance.py:1185).
* Batch-major (B, T, F) inputs; the scan carries an (B, 2r) state.
* Masked timesteps (all-features == mask_value, reference Masking layer
  semantics) hold the carried state.
"""

import os
from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

_EPS7 = 1e-7


@dataclass(frozen=True)
class DRNMFConfig:
    input_dim: int = 257
    r: int = 1000  # per-source atoms; hidden dim is 2r
    output_dim: int = 257
    K_layers: int = 2
    alph: float = 400.0
    lam1: float = 1.0
    mask_value: float = -1.0
    untie_alph: bool = False  # alph becomes a (2r,) vector
    params_untied: tuple = ("log_D", "log_alph")
    params_trainable: tuple = ("log_D", "log_alph")
    transform_before_irm: Optional[str] = None  # None | 'square'
    # cell capability flags mirroring SimpleDeepRNN (custom_layers.py:131-168)
    activation: str = "relu"  # relu | tanh | sigmoid | linear
    connect_input_to_layers: bool = True  # x_t fed to every layer k (:366-368)
    nonnegative: bool = True  # h0 = softplus(log_h0); else plain zero-init h0
    return_all_hidden: bool = False  # concat all K layers' hidden per step
    dropout_W: float = 0.0  # variational input dropout (get_constants :377-395)
    dropout_U: float = 0.0  # variational recurrent dropout
    # rematerialize the scan step in the backward pass: trades recompute
    # for not storing per-step intermediates across T timesteps; no effect
    # on forward-only (inference) programs.
    remat: bool = True
    # what the checkpointed backward is allowed to KEEP from the forward:
    # 'full' recomputes everything per step (min memory, the backward
    # replays each step's matmuls); 'dots' saves dot/matmul outputs and
    # recomputes only elementwise ops
    # (jax.checkpoint_policies.checkpoint_dots); 'none' stores every
    # per-step residual (max memory, no recompute); 'auto' (default)
    # resolves per program at trace time from the closed-form residual
    # bound ``scan_residual_bytes``: 'none' when store-all residuals fit
    # the DRNMF_REMAT_AUTO_BUDGET_BYTES budget (default 4 GB), else 'full'
    # -- storing avoids the backward's replay of every step's matmuls
    # without risking OOM at larger shapes.  Identical math at every
    # setting.  Ignored when remat=False.
    remat_policy: str = "auto"  # 'auto' | 'none' | 'full' | 'dots'
    # lax.scan unroll factor for the recurrence: >1 replicates the step
    # body so XLA amortizes per-iteration loop overhead and can pipeline
    # across timesteps.  Pure scheduling -- identical math and results at
    # any value; memory grows with the unrolled body.  T need not divide
    # it (lax.scan handles the remainder).  Default 4, where the gain is
    # in the BACKWARD pass; larger unrolls grow the forward program.
    scan_unroll: int = 4
    # Batched-T backward (models/batched_grad.py): replace autodiff's
    # through-the-scan parameter-gradient accumulation (per-timestep
    # matmuls contracting over the 32-row batch) with a custom VJP that
    # runs only the sequential delta chain in the reverse scan and
    # computes every weight gradient as ONE
    # T*B-contraction matmul.  Identical forward numerics; gradient
    # parity pinned by tests.  Applies to the production path (relu,
    # connect_input, frozen-U fold + factored S); other configurations
    # fall back to autodiff.  Residual memory is the (T, K, B, 2r)
    # hidden+delta stacks; the router falls back to remat autodiff when
    # that exceeds DRNMF_BATCHED_GRAD_BUDGET_BYTES (default 4 GB).
    batched_grad: bool = False
    # matmul precision: 'default' follows jax.default_matmul_precision and
    # otherwise lets XLA run float32 matmuls in its fastest class (TF32 on
    # tensor cores on an H100; chip_smoke.py holds the result to the
    # 0.1 dB SDR parity budget), 'highest' asks for full float32.
    matmul_precision: str = "default"
    # When log_U1/log_Uk are NOT trainable (every shipped reference config:
    # params_trainable is [log_D, log_alph], e.g.
    # data_setup_downsample1/configs/params_unfolded_snmf_*.yaml:10) they
    # stay frozen at their init values U1 = 1e-7*J + I, Uk = 1e-7*J
    # (enhance.py:220-221 via the log(1e-7 + .) floor at :147).  Those are
    # rank-one-structured, so the K per-step (B,2r)x(2r,2r) U matmuls --
    # over half the recurrence FLOPs -- collapse to one row-sum.  Exact up
    # to float reassociation; auto-disabled whenever U is trainable.
    fold_frozen_U: bool = True
    # S_k = (I - (Dhat/alph)^T Dhat)^T = I - Dhat^T (Dhat/alph) is identity
    # minus a rank-F correction (F=input_dim << 2r for every paper config):
    # apply it as h - (h @ Dhat^T) @ (Dhat/alph) -- two thin F-contraction
    # matmuls instead of one dense (2r, 2r) one.  Pure reassociation of the
    # same float math (valid ALWAYS, including while D trains; gradients
    # flow through the factors); 2r/F-fold fewer FLOPs and no (2r, 2r) S
    # materialization.  The dense path stays for the tests' A/B.
    factored_S: bool = True

    @property
    def hidden_dim(self) -> int:
        return 2 * self.r

    def untied_names(self, base: str) -> list:
        if base in self.params_untied:
            return [f"{base}_{k}" for k in range(self.K_layers)]
        return [base] * self.K_layers


def init_drnmf_params(config: DRNMFConfig, w_noisy: np.ndarray, key=None) -> dict:
    """Build the alternate-parameter pytree from an SNMF dictionary.

    ``w_noisy``: (input_dim, 2r) nonnegative dictionary [W_clean, W_noise]
    with unit-L2 columns (the output of the two-stage SNMF recipe).

    Mirrors reference init (enhance.py:147, 219-223, 282-292): log-domain
    storage with a 1e-7 floor; U1 init ~identity, Uk init ~zero, trainable
    softplus h0 init from uniform(-0.05, 0.05) (Keras 'uniform' initializer).
    """
    if key is None:
        key = jax.random.PRNGKey(7654)
    n2r = config.hidden_dim
    f = config.input_dim
    w_noisy = np.asarray(w_noisy, np.float32)
    assert w_noisy.shape == (f, n2r), (w_noisy.shape, (f, n2r))

    alph0 = np.float32(config.alph)
    if config.untie_alph:
        alph0 = alph0 * np.ones((n2r,), np.float32)

    params = {
        "log_U1": np.log(_EPS7 + np.eye(n2r, dtype=np.float32)),
        "log_Uk": np.log(_EPS7 + np.zeros((n2r, n2r), np.float32)),
        "log_W_clean": np.log(_EPS7 + w_noisy[:, : config.r].T),
        "log_W_noise": np.log(_EPS7 + w_noisy[:, config.r :].T),
    }
    if config.nonnegative:
        params["log_h0"] = np.asarray(
            jax.random.uniform(key, (n2r,), jnp.float32, -0.05, 0.05)
        )
    else:
        # flag_nonnegative=False: plain zero-init trainable h0
        # (custom_layers.py:208-211)
        params["h0"] = np.zeros((n2r,), np.float32)
    base = {
        "log_D": np.log(_EPS7 + w_noisy),
        "log_alph": np.log(_EPS7 + alph0),
        "log_lam1": np.log(np.float32(_EPS7 + config.lam1)),
    }
    for name, value in base.items():
        if name in config.params_untied:
            for k in range(config.K_layers):
                params[f"{name}_{k}"] = np.array(value, copy=True)
        else:
            params[name] = value
    return {k: jnp.asarray(v) for k, v in params.items()}


def flagship(seed: int = 7654):
    """The largest model of the reference's paper grid
    (run_waspaa2017.sh: DR-NMF K=5, 2r=2000 atoms, F=257 from a 512-point
    STFT): untied, trainable log_D/log_alph and a random unit-norm
    dictionary drawn from ``seed``.  Returns (config, params).

    The atoms are sparse gamma(0.1) draws, so ||D^T D||_2 stays near 200,
    below alph=400: each unfolded layer is then a stable ISTA step and
    every layer is live.  Dense positive atoms are so coherent that
    ||D^T D||_2 exceeds 1000; the layers then alternate between all-zero
    and live, and no gradient reaches the lower ones."""
    config = DRNMFConfig(
        input_dim=257, r=1000, output_dim=257, K_layers=5,
        alph=400.0, lam1=1.0,
        params_untied=("log_D", "log_alph"),
        params_trainable=("log_D", "log_alph"),
    )
    rng = np.random.default_rng(seed)
    w = rng.gamma(0.1, 1.0, (257, 2000)).astype(np.float32) + 1e-3
    w /= np.sqrt(np.sum(w**2, axis=0))
    return config, init_drnmf_params(config, w)


def drnmf_trainable_mask(config: DRNMFConfig, params: dict) -> dict:
    """True where a parameter receives gradients.

    The reference trains: the listed ``params_trainable`` (expanded per-layer
    when untied, enhance.py:239-248), the initial state log_h0 (a trainable
    Keras weight, custom_layers.py:202-206), and both reconstruction-head
    kernels (ordinary Dense layers)."""
    trainable = set()
    for name in config.params_trainable:
        if name in config.params_untied:
            trainable.update(f"{name}_{k}" for k in range(config.K_layers))
        else:
            trainable.add(name)
    trainable.update({"log_h0", "h0", "log_W_clean", "log_W_noise"})
    return {k: (k in trainable) for k in params}


class FoldedU:
    """Rank-one-structured frozen recurrence matrices (see
    ``DRNMFConfig.fold_frozen_U``): U1 = off1*J + diag(diag1 - off1),
    Uk = c*J, extracted from the actual stored params so the folded path
    reproduces the exact float values the dense path would use."""

    __slots__ = ("diag1", "off1", "c")

    def __init__(self, diag1, off1, c):
        self.diag1, self.off1, self.c = diag1, off1, c


def u_is_foldable(config: DRNMFConfig) -> bool:
    """True when the U matrices are frozen at their structured init values
    (not trainable) and folding is enabled."""
    return (config.fold_frozen_U
            and "log_U1" not in config.params_trainable
            and "log_Uk" not in config.params_trainable)


def fold_structure_holds(params: dict) -> bool:
    """Host-side structural check of the rank-one fold's assumption: FoldedU
    reads only diag(log_U1), log_U1[0,1], and log_Uk[0,0], which is exact
    only when log_U1's off-diagonal is uniform and log_Uk is a constant
    matrix (the init of init_drnmf_params / enhance.py:220-221).  A
    checkpoint whose frozen U deviates (config/checkpoint mismatch, or U
    trained in an earlier stage and then frozen) would otherwise silently
    compute wrong hidden states through the folded path."""
    lu1 = np.asarray(params.get("log_U1"))
    luk = np.asarray(params.get("log_Uk"))
    if lu1 is None or luk is None or lu1.ndim != 2 or luk.ndim != 2:
        return False
    n = lu1.shape[0]
    if lu1.shape != (n, n) or luk.shape != (n, n):
        return False
    if n > 1:
        off_mask = ~np.eye(n, dtype=bool)
        if not np.all(lu1[off_mask] == lu1[0, 1]):
            return False
    return bool(np.all(luk == luk.flat[0]))


def ensure_fold_valid(config: DRNMFConfig, params: dict,
                      verbose: bool = True) -> DRNMFConfig:
    """Validate loaded params against the frozen-U fold; disable the fold
    (returning an updated config) when the structural assumption does not
    hold.  Call after every checkpoint/warm-start load (ADVICE r2)."""
    if not u_is_foldable(config) or fold_structure_holds(params):
        return config
    if verbose:
        print("fold_frozen_U disabled: checkpointed log_U1/log_Uk do not "
              "have the structured init form the rank-one fold assumes "
              "(running the exact dense-U path instead)")
    import dataclasses

    return dataclasses.replace(config, fold_frozen_U=False)


def s_apply(S_k, hidden, prec):
    """hidden @ S_k, where S_k is either a dense (2r, 2r) matrix or the
    factored pair (dk, dka) with dk = Dhat (F, 2r) and dka = Dhat/alph:
    hidden @ S = hidden - (hidden @ Dhat^T) @ (Dhat/alph)."""
    if isinstance(S_k, tuple):
        dk, dka = S_k
        t = jnp.dot(hidden, dk.T, precision=prec,
                    preferred_element_type=jnp.float32)  # (B, F)
        return hidden - jnp.dot(t, dka, precision=prec,
                                preferred_element_type=jnp.float32)
    return jnp.dot(hidden, S_k, precision=prec,
                   preferred_element_type=jnp.float32)


def layer_pre(k, u_k, hidden, x_eff, S, W, config, prec):
    """Bias-free pre-activation of layer k:
    ``u_k (+ hidden @ S_{k-1} for k>0) (+ x_eff @ W_k)``.

    When S is factored AND the input feeds every layer, W_k = Dhat_k/alph_k
    is the SAME matrix as the second S factor (enhance.py:184-195 vs
    :171-181), so the S and W terms fuse into the literal ISTA residual
    form ``u_k + hidden + (x_eff - hidden @ Dhat^T) @ (Dhat/alph)`` --
    eliminating the separate input-projection matmul for layers k > 0."""
    dot = partial(jnp.dot, precision=prec,
                  preferred_element_type=jnp.float32)
    if k == 0:
        return (u_k + dot(x_eff, W[0])
                if config.connect_input_to_layers else u_k)
    S_k = S[k - 1]
    if isinstance(S_k, tuple) and config.connect_input_to_layers:
        dk, dka = S_k
        return u_k + hidden + dot(x_eff - dot(hidden, dk.T), dka)
    pre = u_k + s_apply(S_k, hidden, prec)
    if config.connect_input_to_layers:
        pre = pre + dot(x_eff, W[k])
    return pre


def u_terms(U, h, K: int, prec):
    """Per-layer U contributions [h @ U_k for k in range(K)] -- one row-sum
    when U is a FoldedU, K dense matmuls otherwise.  For FoldedU:
    (h @ U1)_j = off1*rowsum(h) + (diag1_j - off1)*h_j and
    h @ Uk = c*rowsum(h) (broadcast), shared by all layers k > 1."""
    if isinstance(U, FoldedU):
        rs = jnp.sum(h, axis=-1, keepdims=True)
        t1 = h * (U.diag1 - U.off1) + U.off1 * rs
        tk = U.c * rs  # (B, 1), broadcasts against (B, 2r)
        return [t1] + [tk] * (K - 1)
    return [jnp.dot(h, U[k], precision=prec,
                    preferred_element_type=jnp.float32) for k in range(K)]


def _effective_matrices(params: dict, config: DRNMFConfig,
                        fold_u: bool = False, factor_s: bool = False):
    """Materialize per-layer U, S, W, b from the alt params (enhance.py:162-204).

    With ``fold_u`` (and foldable U, see ``u_is_foldable``) U is returned as
    a ``FoldedU`` instead of K dense (2r, 2r) matrices.  With ``factor_s``
    (and ``config.factored_S``) each S_k is returned as its factored pair
    (Dhat, Dhat/alph) for ``s_apply`` instead of a dense (2r, 2r) matrix."""
    K = config.K_layers
    d_names = config.untied_names("log_D")
    a_names = config.untied_names("log_alph")
    l_names = config.untied_names("log_lam1")

    def dhat(k):
        d = jnp.exp(params[d_names[k]])
        return d / jnp.sqrt(jnp.sum(d * d, axis=0, keepdims=True))

    if fold_u and u_is_foldable(config):
        # U1 = exp(log_U1)^T has constant off-diagonals and an arbitrary
        # diagonal; Uk = exp(log_Uk)^T is a constant matrix.  Both patterns
        # are symmetric, so the transpose is free.  stop_gradient: folding
        # is only valid for FROZEN U, so U is a constant of the autodiff
        # graph (log_U1/log_Uk receive exact-zero gradients instead of the
        # dense path's dead, optimizer-masked values).
        sg = jax.lax.stop_gradient
        U = FoldedU(
            diag1=sg(jnp.exp(jnp.diagonal(params["log_U1"]))),
            off1=sg(jnp.exp(params["log_U1"][0, 1])),
            c=sg(jnp.exp(params["log_Uk"][0, 0])),
        )
    else:
        U = [jnp.exp(params["log_U1"]).T] + [
            jnp.exp(params["log_Uk"]).T for _ in range(K - 1)
        ]
    eye = jnp.eye(config.hidden_dim, dtype=jnp.float32)
    S = []
    for k in range(1, K):
        dk = dhat(k)
        alph = jnp.exp(params[a_names[k]])
        if factor_s and config.factored_S:
            # S = (I - (dk/alph)^T dk)^T = I - dk^T (dk/alph); s_apply
            # consumes the factors without materializing the (2r, 2r) matrix
            S.append((dk, dk / alph))
        else:
            S.append((eye - jnp.dot((dk / alph).T, dk,
                                    preferred_element_type=jnp.float32)).T)
    W = [dhat(k) / jnp.exp(params[a_names[k]]) for k in range(K)]
    b = [
        -jnp.ones((config.hidden_dim,), jnp.float32)
        * jnp.exp(params[l_names[k]])
        / jnp.exp(params[a_names[k]])
        for k in range(K)
    ]
    return U, S, W, b


_ACTIVATIONS = {
    "relu": jax.nn.relu,
    "tanh": jnp.tanh,
    "sigmoid": jax.nn.sigmoid,
    "linear": lambda v: v,
}


def make_cell_step(config: DRNMFConfig, U, S, W, b):
    """One DR-NMF timestep honoring activation / connect_input_to_layers /
    matmul_precision -- the shared cell for the inference-path consumers
    (streaming, sequence-pipelined scan).  No dropout (inference) and no
    return_all_hidden (callers consume the top layer).  ``U`` may be a
    ``FoldedU`` (frozen rank-one recurrence, see ``fold_frozen_U``).

    step(h_prev (B, 2r), x_t (B, F)) -> hidden (B, 2r)."""
    act = _ACTIVATIONS[config.activation]
    prec = _precision(config)

    def step(h_prev, x_t):
        hidden = None
        u = u_terms(U, h_prev, config.K_layers, prec)
        for k in range(config.K_layers):
            pre = layer_pre(k, u[k], hidden, x_t, S, W, config, prec)
            hidden = act(pre + b[k])
        return hidden

    return step


def _dropout_mask(key, shape, rate):
    """Keras K.dropout semantics: Bernoulli keep mask scaled by 1/(1-rate),
    fixed per sequence (variational dropout, custom_layers.py:377-395)."""
    keep = jax.random.bernoulli(key, 1.0 - rate, shape)
    return keep.astype(jnp.float32) / (1.0 - rate)


def _precision(config: DRNMFConfig):
    """'default' leaves the choice to ``jax.default_matmul_precision`` (so a
    reference run under ``highest`` reaches the model's matmuls too);
    'highest' pins full float32."""
    return {"default": None,
            "highest": jax.lax.Precision.HIGHEST}[config.matmul_precision]


def scan_residual_bytes(config: DRNMFConfig, bsz: int, T: int) -> int:
    """Closed-form upper bound on the f32 residuals the un-rematerialized
    scan backward stores across T timesteps: per step the K pre-activation
    and K hidden tensors, the K recurrent/skip input terms (each (B, 2r)),
    plus carry/output bookkeeping (~3 more (B, 2r)) and the (B, F) input
    term.  Flagship (K=5, B=32, T=500, 2r=2000): ~2.3 GB."""
    per_step = bsz * ((3 * config.K_layers + 3) * config.hidden_dim
                      + config.input_dim)
    return 4 * per_step * T


def resolve_remat_policy(config: DRNMFConfig, bsz: int, T: int) -> str:
    """Resolve 'auto' to a concrete policy at trace time: 'none'
    (store-all, no backward recompute) when the residual bound fits the
    DRNMF_REMAT_AUTO_BUDGET_BYTES budget, else 'full'."""
    if config.remat_policy != "auto":
        return config.remat_policy
    budget = float(os.environ.get("DRNMF_REMAT_AUTO_BUDGET_BYTES", 4e9))
    return "none" if scan_residual_bytes(config, bsz, T) <= budget else "full"


def _scan_hidden(params: dict, config: DRNMFConfig, x: jnp.ndarray,
                 step_mask: jnp.ndarray, rng=None,
                 training: bool = False) -> jnp.ndarray:
    """Run the recurrence.  x: (B, T, F); step_mask: (B, T) bool.
    Returns hidden states (B, T, 2r), or (B, T, K*2r) with
    ``return_all_hidden``."""
    K = config.K_layers
    U, S, W, b = _effective_matrices(params, config, fold_u=True,
                                     factor_s=True)
    if config.nonnegative:
        h0 = jax.nn.softplus(params["log_h0"])
    else:
        h0 = params["h0"]
    bsz = x.shape[0]
    act = _ACTIVATIONS[config.activation]

    use_dropout = training and (config.dropout_U > 0 or config.dropout_W > 0)
    if use_dropout:
        if rng is None:
            raise ValueError("dropout requires an rng key at training time")
        ku, kw = jax.random.split(rng)
        b_u = (_dropout_mask(ku, (bsz, config.hidden_dim), config.dropout_U)
               if config.dropout_U > 0 else 1.0)
        b_w = (_dropout_mask(kw, (bsz, x.shape[-1]), config.dropout_W)
               if config.dropout_W > 0 else 1.0)
    else:
        b_u = b_w = 1.0

    plain = (config.activation == "relu" and config.connect_input_to_layers
             and not config.return_all_hidden and not use_dropout)

    h_init = jnp.broadcast_to(h0[None, :], (bsz, config.hidden_dim))

    xT = jnp.swapaxes(x, 0, 1)  # (T, B, F)
    mT = jnp.swapaxes(step_mask, 0, 1)  # (T, B)

    if (config.batched_grad and plain and isinstance(U, FoldedU)
            and config.connect_input_to_layers
            and (K == 1 or isinstance(S[0], tuple))):
        from .batched_grad import (batched_grad_residual_bytes,
                                   scan_plain_batched)

        budget = float(os.environ.get("DRNMF_BATCHED_GRAD_BUDGET_BYTES",
                                      4e9))
        if batched_grad_residual_bytes(
                bsz, xT.shape[0], config.hidden_dim, K) <= budget:
            hs = scan_plain_batched(
                (K, max(1, config.scan_unroll), _precision(config)),
                (U.diag1, U.off1, U.c),
                [s[0] for s in S], [s[1] for s in S], W[0], list(b),
                h_init, xT,
                jax.lax.stop_gradient(mT.astype(jnp.float32)))
            return jnp.swapaxes(hs, 0, 1)

    if config.return_all_hidden:
        # carry = concat of all K layers' hidden; the recurrent input is the
        # last block (custom_layers.py:345-347, 371-374); h0 tiled K times
        h_init = jnp.tile(h_init, (1, K))

    prec = _precision(config)

    def step(carry, inp):
        x_t, m_t = inp
        h_prev = carry[:, -config.hidden_dim:] if config.return_all_hidden else carry
        hidden = None
        outs = []
        u = u_terms(U, h_prev * b_u, K, prec)
        x_eff = x_t * b_w
        for k in range(K):
            pre = layer_pre(k, u[k], hidden, x_eff, S, W, config, prec)
            hidden = act(pre + b[k])
            outs.append(hidden)
        out = jnp.concatenate(outs, axis=1) if config.return_all_hidden else hidden
        new_carry = jnp.where(m_t[:, None], out, carry)
        return new_carry, new_carry

    if config.remat:
        policy_name = resolve_remat_policy(config, bsz, xT.shape[0])
        if policy_name == "full":
            step = jax.checkpoint(step)
        elif policy_name == "dots":
            step = jax.checkpoint(
                step, policy=jax.checkpoint_policies.checkpoint_dots)
        elif policy_name != "none":
            raise ValueError(
                f"remat_policy must be 'auto', 'none', 'full' or 'dots', "
                f"got {config.remat_policy!r}"
            )
    _, hs = jax.lax.scan(step, h_init, (xT, mT),
                         unroll=max(1, config.scan_unroll))
    return jnp.swapaxes(hs, 0, 1)  # (B, T, 2r) or (B, T, K*2r)


def _heads(params: dict, config: DRNMFConfig, hidden: jnp.ndarray):
    """Nonnegative reconstruction heads (DenseNonNegW: x @ exp(kernel)).
    With ``return_all_hidden`` the heads consume the top layer's block."""
    top = hidden[..., -config.hidden_dim:]
    h_clean = top[..., : config.r]
    h_noise = top[..., config.r :]
    prec = _precision(config)
    clean_est = jnp.dot(
        h_clean, jnp.exp(params["log_W_clean"]), precision=prec,
        preferred_element_type=jnp.float32
    )
    noise_est = jnp.dot(
        h_noise, jnp.exp(params["log_W_noise"]), precision=prec,
        preferred_element_type=jnp.float32
    )
    return clean_est, noise_est


def _ratio_mask(clean_est, noise_est, transform: Optional[str]):
    """Numerically stable A/(A+B) (custom_layers.py:41-45)."""
    if transform == "square":
        clean_est = jnp.square(clean_est)
        noise_est = jnp.square(noise_est)
    return jnp.exp(
        jnp.log(_EPS7 + clean_est) - jnp.log(_EPS7 + clean_est + noise_est)
    )


def step_mask_from_input(x: jnp.ndarray, mask_value: float) -> jnp.ndarray:
    """Keras Masking semantics: a timestep is masked iff every feature equals
    mask_value.  (B, T, F) -> (B, T) bool (True = valid)."""
    return jnp.any(x != mask_value, axis=-1)


def drnmf_forward(params: dict, config: DRNMFConfig, x: jnp.ndarray,
                  return_parts: bool = False, rng=None,
                  training: bool = False):
    """Unjitted forward pass: noisy magnitude spectrogram (B, T, F) -> ratio
    mask.  With ``return_parts=True`` also returns (hidden, clean_est,
    noise_est) for the SNMF-cost pretraining path (enhance.py:1024-1036).
    ``rng``/``training`` enable the variational dropout masks when
    ``dropout_W``/``dropout_U`` are set."""
    step_mask = step_mask_from_input(x, config.mask_value)
    hidden = _scan_hidden(params, config, x, step_mask, rng=rng,
                          training=training)
    clean_est, noise_est = _heads(params, config, hidden)
    irm = _ratio_mask(clean_est, noise_est, config.transform_before_irm)
    if return_parts:
        return irm, hidden, clean_est, noise_est
    return irm


drnmf_apply = partial(
    jax.jit, static_argnames=("config", "return_parts", "training")
)(drnmf_forward)
