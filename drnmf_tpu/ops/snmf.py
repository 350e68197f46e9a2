"""Sparse NMF with beta-divergence, L1 sparsity, and normalized basis columns.

JAX reimplementation of the reference's "well-done" sparse NMF engine
(Le Roux, Hershey & Weninger, MERL TR2015-023).  The reference runs these
multiplicative updates in MATLAB on a CUDA GPU via the Parallel Computing
Toolbox (reference: sparseNMF/sparse_nmf_gpu.m:1-304, shimmed through a
``.mat``-file process boundary by snmf.py:9-113).  Here the whole algorithm is
a single jit'd XLA program: the MU iteration runs as a ``lax.while_loop`` on
device with the ``conv_eps`` relative-cost early stop, and the frame-chunked
driver (reference snmf.py frame batching for 12 GB GPUs) becomes an optional
host loop with warm-started ``W`` for datasets larger than HBM.

Update equations reproduced behaviorally (sparse_nmf_gpu.m:208-298):

* H update (beta=2 shown): ``h <- h * (W^T v) / max(W^T lambda + sparsity, flr)``
* W update: ``w <- w * (v h^T + w * sum(lambda h^T . w)) / max(lambda h^T + w * sum(v h^T . w), flr)``
  -- the normalization-aware form that keeps the update consistent with
  unit-L2 column constraints -- followed by explicit column re-normalization.
* ``lambda = max(W h, flr)`` with ``flr = 1e-9``.
* Frozen subsets via ``w_update_ind`` / ``h_update_ind`` (used to freeze the
  speech dictionary while learning the noise dictionary, and to freeze all of
  W at inference).  Implemented as dense full-width updates followed by a
  ``where`` select -- no gathers, full-width matmuls throughout.
* beta=1 (KL) and beta=0 (IS) and generic beta paths, objective history,
  early stop on relative cost change.

Multi-device: :func:`sparse_nmf_sharded` shards frames (columns of ``v``)
across a mesh axis; the W-update numerator/denominator statistics are
``psum``-reduced over the axis so all shards hold identical dictionaries.
"""

from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

_FLR = 1e-9


@dataclass
class SNMFParams:
    """Mirrors the reference's params struct (sparse_nmf_gpu.m:74-170).

    ``cf`` in {'is','kl','ed'} overrides ``beta`` (0, 1, 2 respectively).
    """

    r: int = 100
    cf: str = "kl"
    beta: Optional[float] = None
    sparsity: float = 0.0
    max_iter: int = 100
    conv_eps: float = 0.0
    random_seed: int = 1
    init_w: Optional[np.ndarray] = None
    init_h: Optional[np.ndarray] = None
    w_update_ind: Optional[np.ndarray] = None  # bool (r,)
    h_update_ind: Optional[np.ndarray] = None  # bool (r,)
    display: bool = False

    def resolved_beta(self) -> float:
        if self.cf == "is":
            return 0.0
        if self.cf == "kl":
            return 1.0
        if self.cf == "ed":
            return 2.0
        return 1.0 if self.beta is None else float(self.beta)


@dataclass
class SNMFResult:
    w: np.ndarray
    h: np.ndarray
    div: np.ndarray  # objective divergence per iteration (trimmed to n_iter)
    cost: np.ndarray  # divergence + sparsity penalty per iteration
    n_iter: int


def _h_update(v, w, h, lam, sparsity, h_mask, beta):
    if beta == 1.0:
        dph = jnp.sum(w, axis=0)[:, None] + sparsity
        dmh = jnp.dot(w.T, v / lam, preferred_element_type=jnp.float32)
    elif beta == 2.0:
        dph = jnp.dot(w.T, lam, preferred_element_type=jnp.float32) + sparsity
        dmh = jnp.dot(w.T, v, preferred_element_type=jnp.float32)
    else:
        dph = jnp.dot(w.T, lam ** (beta - 1.0), preferred_element_type=jnp.float32) + sparsity
        dmh = jnp.dot(w.T, v * lam ** (beta - 2.0), preferred_element_type=jnp.float32)
    h_new = h * dmh / jnp.maximum(dph, _FLR)
    return jnp.where(h_mask[:, None], h_new, h)


def _w_statistics(v, w, h, lam, beta):
    """Per-shard W-update statistics.  All four are (m, r) / (r,) shaped and
    additive over frame shards -- the psum boundary for sharded NMF."""
    if beta == 1.0:
        a = jnp.dot(v / lam, h.T, preferred_element_type=jnp.float32)  # m x r
        b = jnp.sum(h, axis=1)  # r,
        return a, b
    if beta == 2.0:
        a = jnp.dot(v, h.T, preferred_element_type=jnp.float32)
        b = jnp.dot(lam, h.T, preferred_element_type=jnp.float32)
        return a, b
    a = jnp.dot(v * lam ** (beta - 2.0), h.T, preferred_element_type=jnp.float32)
    b = jnp.dot(lam ** (beta - 1.0), h.T, preferred_element_type=jnp.float32)
    return a, b


def _w_update_from_stats(w, stats, w_mask, beta):
    """Apply the normalization-aware multiplicative W update given the frame
    -reduced statistics, then re-normalize columns (sparse_nmf_gpu.m:232-264)."""
    a, b = stats
    if beta == 1.0:
        # a = (v/lam) h^T, b = sum(h, axis=1)
        c = jnp.sum(a * w, axis=0)  # r,
        dpw = b[None, :] + c[None, :] * w
        dmw = a + jnp.sum(b[None, :] * w, axis=0)[None, :] * w
    else:
        # a = (v .* lam^(b-2)) h^T, b = lam^(b-1) h^T   (beta=2: a = v h^T, b = lam h^T)
        dpw = b + jnp.sum(a * w, axis=0)[None, :] * w
        dmw = a + jnp.sum(b * w, axis=0)[None, :] * w
    w_new = w * dmw / jnp.maximum(dpw, _FLR)
    w = jnp.where(w_mask[None, :], w_new, w)
    w = w / jnp.sqrt(jnp.sum(w * w, axis=0, keepdims=True))
    return w


def _divergence(v, lam, beta):
    if beta == 1.0:
        return jnp.sum(v * jnp.log(v / lam) - v + lam)
    if beta == 2.0:
        return jnp.sum((v - lam) ** 2)
    if beta == 0.0:
        return jnp.sum(v / lam - jnp.log(v / lam) - 1.0)
    return jnp.sum(
        v**beta + (beta - 1.0) * lam**beta - beta * v * lam ** (beta - 1.0)
    ) / (beta * (beta - 1.0))


@partial(
    jax.jit,
    static_argnames=("beta", "max_iter", "conv_eps"),
)
def _sparse_nmf_core(v, w0, h0, sparsity, w_mask, h_mask, beta, max_iter, conv_eps):
    """One fused on-device MU optimization (single frame chunk)."""
    update_w = jnp.any(w_mask)
    update_h = jnp.any(h_mask)

    # Normalize W columns, rescale H accordingly (sparse_nmf_gpu.m:163-166).
    wn = jnp.sqrt(jnp.sum(w0 * w0, axis=0))
    w0 = w0 / wn[None, :]
    h0 = h0 * wn[:, None]

    if beta != 2.0:
        # keep zero entries of v slightly positive (sparse_nmf_gpu.m:201-205)
        vmin = jnp.min(jnp.where(v > 0, v, jnp.inf))
        v = jnp.where(v == 0, vmin, v)

    lam0 = jnp.maximum(jnp.dot(w0, h0, preferred_element_type=jnp.float32), _FLR)

    def body(carry):
        w, h, lam, last_cost, it, divs, costs, done = carry

        h_new = _h_update(v, w, h, lam, sparsity, h_mask, beta)
        h = jnp.where(update_h, h_new, h)
        lam = jnp.where(
            update_h,
            jnp.maximum(jnp.dot(w, h, preferred_element_type=jnp.float32), _FLR),
            lam,
        )

        stats = _w_statistics(v, w, h, lam, beta)
        w_new = _w_update_from_stats(w, stats, w_mask, beta)
        w = jnp.where(update_w, w_new, w)
        lam = jnp.where(
            update_w,
            jnp.maximum(jnp.dot(w, h, preferred_element_type=jnp.float32), _FLR),
            lam,
        )

        div = _divergence(v, lam, beta)
        cost = div + jnp.sum(sparsity * h)
        divs = divs.at[it].set(div)
        costs = costs.at[it].set(cost)

        converged = jnp.logical_and(
            it > 0,
            jnp.logical_and(
                conv_eps > 0, jnp.abs(cost - last_cost) / last_cost < conv_eps
            ),
        )
        return (w, h, lam, cost, it + 1, divs, costs, converged)

    def cond(carry):
        _, _, _, _, it, _, _, done = carry
        return jnp.logical_and(it < max_iter, jnp.logical_not(done))

    divs = jnp.zeros((max_iter,), jnp.float32)
    costs = jnp.zeros((max_iter,), jnp.float32)
    init = (w0, h0, lam0, jnp.float32(jnp.inf), jnp.int32(0), divs, costs, jnp.bool_(False))
    w, h, lam, _, n_iter, divs, costs, _ = jax.lax.while_loop(cond, body, init)
    return w, h, divs, costs, n_iter


def _prepare(v_shape, params: SNMFParams, key):
    m, n = v_shape
    r = int(params.r)
    kw, kh = jax.random.split(key)
    if params.init_w is not None:
        ri = params.init_w.shape[1]
        if ri < r:
            w0 = jnp.concatenate(
                [jnp.asarray(params.init_w, jnp.float32),
                 jax.random.uniform(kw, (m, r - ri), jnp.float32)],
                axis=1,
            )
        else:
            # init_w wider than params.r: adopt r = ri, like the reference
            # (sparse_nmf_gpu.m:125-135 sets r to size(init_w, 2)) -- h0
            # and the default update masks below must match the adopted
            # width or the solve fails on a shape mismatch
            r = ri
            w0 = jnp.asarray(params.init_w, jnp.float32)
    else:
        w0 = jax.random.uniform(kw, (m, r), jnp.float32)
    if params.init_h is not None:
        if isinstance(params.init_h, str) and params.init_h == "ones":
            h0 = jnp.ones((r, n), jnp.float32)
        else:
            h0 = jnp.asarray(params.init_h, jnp.float32)
    else:
        h0 = jax.random.uniform(kh, (r, n), jnp.float32)

    w_mask = (
        jnp.asarray(params.w_update_ind, bool)
        if params.w_update_ind is not None
        else jnp.ones((r,), bool)
    )
    h_mask = (
        jnp.asarray(params.h_update_ind, bool)
        if params.h_update_ind is not None
        else jnp.ones((r,), bool)
    )
    sparsity = jnp.asarray(params.sparsity, jnp.float32)
    if sparsity.ndim == 1:
        sparsity = sparsity[:, None]
    return w0, h0, sparsity, w_mask, h_mask


def sparse_nmf(v, params: SNMFParams, key=None,
               device_output: bool = False) -> SNMFResult:
    """Run sparse NMF on a single in-HBM chunk.  v: (m, n) nonnegative.

    ``device_output=True`` leaves W/H as jax arrays in HBM (H is (r, n) --
    at corpus scale fetching it to host costs far more than the solve; keep
    it on device when the consumer is another on-device stage)."""
    if key is None:
        key = jax.random.PRNGKey(int(params.random_seed))
    v = jnp.asarray(v, jnp.float32)
    w0, h0, sparsity, w_mask, h_mask = _prepare(v.shape, params, key)
    w, h, divs, costs, n_iter = _sparse_nmf_core(
        v, w0, h0, sparsity, w_mask, h_mask,
        beta=params.resolved_beta(),
        max_iter=int(params.max_iter),
        conv_eps=float(params.conv_eps),
    )
    n_iter = int(n_iter)
    if device_output:
        jax.block_until_ready(w)
        return SNMFResult(
            w=w, h=h,
            div=np.asarray(divs)[:n_iter],
            cost=np.asarray(costs)[:n_iter],
            n_iter=n_iter,
        )
    return SNMFResult(
        w=np.asarray(w),
        h=np.asarray(h),
        div=np.asarray(divs)[:n_iter],
        cost=np.asarray(costs)[:n_iter],
        n_iter=n_iter,
    )


def default_frame_chunk(r: int, max_frames_at_r200: int = 700_000) -> int:
    """Reference memory heuristic (snmf.py:33-36): frames per chunk scales as
    1/r, anchored at 700k frames for r=200 on a 12 GB device.  The anchor is
    kept as is; any larger device holds such a chunk."""
    return int(float(max_frames_at_r200) * (200.0 / float(r)))


def sparse_nmf_chunked(
    v,
    params: SNMFParams,
    key=None,
    frame_chunk: Optional[int] = None,
    save_h: bool = True,
    verbose: bool = False,
) -> SNMFResult:
    """Frame-chunked sparse NMF with warm-started W between chunks.

    Behavioral port of the reference's chunk driver (snmf.py:9-85): each chunk
    runs a full MU optimization; the learned (updatable columns of) W seed the
    next chunk; per-chunk first/last objective values are summed into a
    two-point [initial, final] objective.
    """
    if key is None:
        key = jax.random.PRNGKey(int(params.random_seed))
    v = np.asarray(v)
    m, n = v.shape
    r = int(params.r)
    if params.init_w is not None and params.init_w.shape[1] > r:
        # _prepare adopts r = init_w width (sparse_nmf_gpu.m:125-135); the
        # chunk driver's H buffer and chunk sizing must match
        r = int(params.init_w.shape[1])
    if frame_chunk is None:
        frame_chunk = default_frame_chunk(r)
    n_chunks = max(1, -(-n // frame_chunk))

    if n_chunks == 1:
        res = sparse_nmf(v, params, key=key, device_output=not save_h)
        if not save_h:
            # only W leaves the device (H can be GBs at corpus scale)
            return SNMFResult(w=np.asarray(res.w), h=None, div=res.div,
                              cost=res.cost, n_iter=res.n_iter)
        return res

    from dataclasses import replace

    h_full = np.zeros((r, n), np.float32) if save_h else None
    init_w = params.init_w
    w_ind = params.w_update_ind
    initial_cost = initial_div = final_cost = final_div = 0.0
    w = None
    for i in range(n_chunks):
        if verbose:
            print(f"sparse NMF: chunk {i + 1} of {n_chunks}")
        key, sub = jax.random.split(key)
        chunk = v[:, i * frame_chunk : (i + 1) * frame_chunk]
        # Slice an explicit init_h to this chunk's frame range.  (The
        # reference passed the full-width init_h into every chunk solve and
        # crashed on >1 chunk -- snmf.py:57 -- fixed here, not copied.)
        init_h = params.init_h
        if init_h is not None and not isinstance(init_h, str):
            init_h = np.asarray(init_h)[:, i * frame_chunk : (i + 1) * frame_chunk]
        res = sparse_nmf(chunk, replace(params, init_w=init_w, init_h=init_h),
                         key=sub, device_output=not save_h)
        if not save_h:
            res = SNMFResult(w=np.asarray(res.w), h=None, div=res.div,
                             cost=res.cost, n_iter=res.n_iter)
        if w_ind is not None and init_w is not None:
            init_w = np.array(init_w, np.float32, copy=True)
            if init_w.shape[1] < r:  # first chunk grew W to full r
                init_w = res.w.copy()
            idx = np.where(np.asarray(w_ind))[0]
            init_w[:, idx] = res.w[:, idx]
        else:
            init_w = res.w
        w = res.w
        if save_h:
            h_full[:, i * frame_chunk : i * frame_chunk + res.h.shape[1]] = res.h
        initial_cost += float(res.cost[0])
        initial_div += float(res.div[0])
        final_cost += float(res.cost[-1])
        final_div += float(res.div[-1])

    return SNMFResult(
        w=w,
        h=h_full,
        div=np.array([initial_div, final_div], np.float32),
        cost=np.array([initial_cost, final_cost], np.float32),
        n_iter=int(params.max_iter),
    )
