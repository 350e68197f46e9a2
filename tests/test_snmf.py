"""Sparse NMF engine tests.

Golden fixture: the plain-numpy transcription of the reference MU equations
(sparseNMF/sparse_nmf_gpu.m:208-298) in drnmf_tpu/reference.py, run from
identical initialization; the
JAX engine must match it to float32 tolerance for beta in {0, 1, 2}.
"""

import numpy as np
import pytest

from drnmf_tpu.ops import SNMFParams, sparse_nmf, sparse_nmf_chunked
from drnmf_tpu.reference import numpy_sparse_nmf


def _rand_problem(rng, m=12, n=40, r=6):
    w0 = rng.uniform(0.1, 1.0, (m, r)).astype(np.float32)
    h0 = rng.uniform(0.1, 1.0, (r, n)).astype(np.float32)
    v = (w0 @ h0 + 0.01 * rng.uniform(size=(m, n))).astype(np.float32)
    return v, w0, h0


@pytest.mark.parametrize("cf,beta", [("ed", 2.0), ("kl", 1.0), ("is", 0.0)])
def test_mu_parity_with_reference_equations(rng, cf, beta):
    v, w0, h0 = _rand_problem(rng)
    params = SNMFParams(r=6, cf=cf, sparsity=0.5, max_iter=25, init_w=w0, init_h=h0)
    res = sparse_nmf(v, params)
    w_ref, h_ref, div_ref, cost_ref = numpy_sparse_nmf(v, w0, h0, beta, 0.5, 25)
    np.testing.assert_allclose(res.w, w_ref, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(res.h, h_ref, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(res.cost, cost_ref, rtol=2e-3)


def test_mu_partial_updates_and_early_stop_match_reference(rng):
    """Frozen W columns, frozen H rows, per-row sparsity and the conv_eps
    early stop against the reference loop: same stopping iteration, same
    factors."""
    v, w0, h0 = _rand_problem(rng, m=14, n=60, r=8)
    w_ind = np.array([True] * 5 + [False] * 3)
    h_ind = np.array([True] * 6 + [False] * 2)
    sparsity = np.linspace(0.1, 0.8, 8)
    params = SNMFParams(r=8, cf="ed", sparsity=sparsity, max_iter=400,
                        conv_eps=1e-3, init_w=w0, init_h=h0,
                        w_update_ind=w_ind, h_update_ind=h_ind)
    res = sparse_nmf(v, params)
    w_ref, h_ref, _, cost_ref = numpy_sparse_nmf(
        v, w0, h0, 2.0, sparsity[:, None], 400, w_ind=w_ind, h_ind=h_ind,
        conv_eps=1e-3)
    assert res.n_iter == len(cost_ref) < 400
    np.testing.assert_allclose(res.w, w_ref, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(res.h, h_ref, rtol=2e-3, atol=2e-4)


def test_cost_monotone_decrease(rng):
    v, w0, h0 = _rand_problem(rng, m=20, n=100, r=8)
    params = SNMFParams(r=8, cf="ed", sparsity=1.0, max_iter=60, init_w=w0, init_h=h0)
    res = sparse_nmf(v, params)
    # The very first iteration can bump the cost slightly (the W-column
    # renormalization changes the L1 term); after that MU must be monotone.
    assert np.all(np.diff(res.cost[1:]) <= 1e-3 * res.cost[1:-1]), "MU cost must not increase"
    assert res.cost[-1] < res.cost[0]


def test_w_freeze(rng):
    """Frozen columns (speech dict) must remain exactly unchanged modulo the
    initial + per-iteration unit normalization (they are already unit norm)."""
    v, w0, h0 = _rand_problem(rng, m=16, n=50, r=8)
    w0 = w0 / np.sqrt(np.sum(w0**2, axis=0))
    w_ind = np.array([False] * 4 + [True] * 4)
    params = SNMFParams(
        r=8, cf="ed", sparsity=0.2, max_iter=30, init_w=w0, init_h=h0, w_update_ind=w_ind
    )
    res = sparse_nmf(v, params)
    np.testing.assert_allclose(res.w[:, :4], w0[:, :4], rtol=1e-5, atol=1e-6)
    assert not np.allclose(res.w[:, 4:], w0[:, 4:])


def test_all_frozen_inference(rng):
    """w_update_ind all-False + conv_eps 0 == the reference's SNMF inference
    mode (enhance.py:838-845): only H moves."""
    v, w0, h0 = _rand_problem(rng)
    w0 = w0 / np.sqrt(np.sum(w0**2, axis=0))
    params = SNMFParams(
        r=6, cf="ed", sparsity=1.0, max_iter=50, init_w=w0, init_h=h0,
        w_update_ind=np.zeros(6, bool),
    )
    res = sparse_nmf(v, params)
    np.testing.assert_allclose(res.w, w0, rtol=1e-5, atol=1e-6)
    # H inference should reduce the cost
    assert res.cost[-1] < res.cost[0]


def test_conv_eps_early_stop(rng):
    v, w0, h0 = _rand_problem(rng)
    params = SNMFParams(
        r=6, cf="ed", sparsity=0.0, max_iter=500, conv_eps=1e-4, init_w=w0, init_h=h0
    )
    res = sparse_nmf(v, params)
    assert res.n_iter < 500
    assert len(res.cost) == res.n_iter


def test_random_init_grows_w(rng):
    """init_w with fewer than r columns gets random extra columns
    (sparse_nmf_gpu.m:129-137) -- the two-stage clean+noise recipe."""
    v, w0, h0 = _rand_problem(rng, r=6)
    params = SNMFParams(r=6, cf="ed", sparsity=0.1, max_iter=10, init_w=w0[:, :3])
    res = sparse_nmf(v, params)
    assert res.w.shape == (12, 6)
    np.testing.assert_allclose(np.sum(res.w**2, axis=0), 1.0, rtol=1e-4)


def test_chunked_warm_start(rng):
    v, w0, h0 = _rand_problem(rng, m=12, n=200, r=6)
    params = SNMFParams(r=6, cf="ed", sparsity=0.3, max_iter=30, init_w=w0)
    res = sparse_nmf_chunked(v, params, frame_chunk=64, verbose=False)
    assert res.w.shape == (12, 6)
    assert res.h.shape == (6, 200)
    assert len(res.cost) == 2  # [initial, final] accumulated over chunks
    assert res.cost[1] < res.cost[0]


def test_chunked_explicit_init_h(rng):
    """An explicit (r, n) init_h must be sliced per chunk.  (The reference
    passed the full-width init_h into every chunk solve and crashed on >1
    chunk -- reference snmf.py:57; we slice instead.)"""
    v, w0, h0 = _rand_problem(rng, m=12, n=200, r=6)
    params = SNMFParams(
        r=6, cf="ed", sparsity=0.3, max_iter=10, init_w=w0, init_h=h0
    )
    res = sparse_nmf_chunked(v, params, frame_chunk=64, verbose=False)
    assert res.w.shape == (12, 6)
    assert res.h.shape == (6, 200)
    # 'ones' string init_h passes through untouched
    params_ones = SNMFParams(
        r=6, cf="ed", sparsity=0.3, max_iter=10, init_w=w0, init_h="ones"
    )
    res2 = sparse_nmf_chunked(v, params_ones, frame_chunk=64, verbose=False)
    assert res2.h.shape == (6, 200)


def test_ista_decreases_cost(rng):
    from drnmf_tpu.ops import ista, beta_div
    import jax.numpy as jnp

    v, w0, h0 = _rand_problem(rng, m=16, n=30, r=8)
    w0 = w0 / np.sqrt(np.sum(w0**2, axis=0))
    lam1, alph = 0.1, 10.0
    h_init = np.abs(rng.standard_normal((8, 30))).astype(np.float32)

    def cost(h, beta):
        xest = w0 @ np.asarray(h)
        return float(np.sum(np.asarray(beta_div(jnp.asarray(v), jnp.asarray(xest), beta)))) + lam1 * np.sum(np.asarray(h))

    for beta in (2.0, 1.0):
        h1 = ista(v, w0, h_init, lam1, alph, 5, beta=beta)
        h2 = ista(v, w0, h_init, lam1, alph, 40, beta=beta)
        assert cost(h2, beta) < cost(h1, beta) < cost(h_init, beta)
        assert np.all(np.asarray(h2) >= 0)


def test_ista_matches_reference_numpy(rng):
    """ista_ed must match the reference's numpy oracle (enhance.py:402-418)."""
    from drnmf_tpu.ops import ista_ed

    v, w0, h0 = _rand_problem(rng, m=16, n=30, r=8)
    w0 = w0 / np.sqrt(np.sum(w0**2, axis=0))
    h = np.abs(rng.standard_normal((8, 30))).astype(np.float32)
    lam1, alph = 0.2, 20.0

    h_np = h.astype(np.float64)
    for _ in range(10):
        xest = w0 @ h_np
        h_np = np.maximum(0, -lam1 / alph + h_np + (1.0 / alph) * (w0.T @ (v - xest)))

    h_jax = np.asarray(ista_ed(v, w0, h, lam1, alph, 10))
    np.testing.assert_allclose(h_jax, h_np, rtol=1e-4, atol=1e-6)


def test_snmf_degenerate_shapes(rng):
    """r=1 and single-frame inputs run and stay finite."""
    import numpy as np
    from drnmf_tpu.ops import SNMFParams
    from drnmf_tpu.ops.snmf import sparse_nmf

    v1 = rng.uniform(0.1, 1.0, (5, 1)).astype(np.float32)
    res = sparse_nmf(v1, SNMFParams(r=1, cf="ed", sparsity=0.1, max_iter=5))
    assert res.w.shape == (5, 1) and res.h.shape == (1, 1)
    assert np.all(np.isfinite(res.w)) and np.all(np.isfinite(res.cost))

    res_kl = sparse_nmf(v1, SNMFParams(r=2, cf="kl", sparsity=0.0, max_iter=5))
    assert np.all(np.isfinite(res_kl.cost))


def test_wider_init_w_adopts_its_rank(rng):
    """init_w with MORE than r columns adopts r = init_w width, like the
    reference (sparse_nmf_gpu.m:125-135 sets r to size(init_w, 2)) -- the
    SNMF-only enhancement path solves H against a full 2r dictionary."""
    v, w0, h0 = _rand_problem(rng, r=6)  # w0 is (12, 6)
    params = SNMFParams(r=3, cf="ed", sparsity=0.1, max_iter=10, init_w=w0)
    res = sparse_nmf(v, params)
    assert res.w.shape == (12, 6)
    assert res.h.shape == (6, v.shape[1])
    assert np.all(np.isfinite(res.cost))
    assert res.cost[-1] < res.cost[0]

    # the chunk driver sizes its H buffer to the adopted rank too
    res_c = sparse_nmf_chunked(v, params, frame_chunk=16, verbose=False)
    assert res_c.w.shape == (12, 6)
    assert res_c.h.shape == (6, v.shape[1])
