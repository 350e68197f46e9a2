"""Checks that need an NVIDIA GPU: the device path against the float64
reference at the flagship width.  They skip without a card; run them on it
with ``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``."""

import dataclasses

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_enhancer_matches_reference_on_gpu(gpu, rng):
    """make_enhancer at matmul_precision='highest' against the dense
    float64 reference: 1 s of audio through the flagship model."""
    import jax
    import jax.numpy as jnp

    from drnmf_tpu.dsp.stft import pad_signal
    from drnmf_tpu.enhance import make_enhancer
    from drnmf_tpu.models import flagship
    from drnmf_tpu.reference import numpy_enhance

    config, params = flagship()
    config = dataclasses.replace(config, matmul_precision="highest")
    x = (0.1 * rng.standard_normal((1, 16000))).astype(np.float32)
    _, y_ref = numpy_enhance(params, config, x)
    with jax.default_device(gpu), jax.default_matmul_precision("highest"):
        out = np.asarray(make_enhancer(config)(
            jax.device_put(params, gpu), pad_signal(jnp.asarray(x), 512,
                                                    128)))
    err = np.max(np.abs(out[:, 512 : 512 + 16000] - y_ref))
    assert err <= 1e-4 * np.max(np.abs(y_ref)), err


def test_sparse_nmf_matches_reference_on_gpu(gpu, rng):
    """The MU iteration on the card at 'highest' against the float64
    reference loop from one initialization."""
    import jax

    from drnmf_tpu.ops import SNMFParams, sparse_nmf
    from drnmf_tpu.reference import numpy_sparse_nmf

    f, r, n = 257, 500, 4000
    v = (rng.gamma(1.0, 1.0, (f, 32)) @ rng.gamma(0.3, 1.0, (32, n))
         ).astype(np.float32)
    w0 = rng.uniform(0.01, 1.0, (f, r)).astype(np.float32)
    h0 = rng.uniform(0.01, 1.0, (r, n)).astype(np.float32)
    params = SNMFParams(r=r, cf="ed", sparsity=1.0, max_iter=10,
                        init_w=w0, init_h=h0)
    with jax.default_device(gpu), jax.default_matmul_precision("highest"):
        res = sparse_nmf(v, params)
    w_ref, h_ref, _, _ = numpy_sparse_nmf(v, w0, h0, 2.0, 1.0, 10)
    for got, ref in ((res.w, w_ref), (res.h, h_ref)):
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-5
