"""Plain float64 numpy reference of the DR-NMF system, independent of JAX.

The tests and ``chip_smoke.py`` hold the device code to these
transcriptions of the reference's equations.  Nothing here shares code
with the implementation under test: the recurrence runs with dense U and
S matrices (no frozen-U fold, no factored S), the STFT frames each window
explicitly, and the overlap-add loops over frames.

* :func:`ref_stft` / :func:`ref_istft` -- ``stft_mc`` and
  ``istft_noDiv`` + ``istft_mc`` trimming (util.py:48-226).
* :func:`numpy_forward` -- the ``SimpleDeepRNN`` step
  (custom_layers.py:343-375) under the ``build_alt`` parameter maps
  (enhance.py:139-206), the exp-kernel heads and the A/(A+B) ratio mask
  (custom_layers.py:15-56).
* :func:`numpy_enhance` -- STFT, recurrence, mask and iSTFT together: the
  offline enhancement path.
* :func:`numpy_sparse_nmf` -- the multiplicative updates of
  sparseNMF/sparse_nmf_gpu.m:208-298.
"""

import numpy as np

EPS7 = 1e-7
FLR = 1e-9


def sqrt_hann(n_fft):
    """Periodic sqrt-Hann window (audio_dataset.py:194), float64."""
    k = np.arange(n_fft, dtype=np.float64)
    return np.sqrt(0.5 - 0.5 * np.cos(2.0 * np.pi * k / n_fft))


def ref_stft(x, n_fft, hop, window):
    """STFT with the reference's padding (util.py:171-201): pad to a hop
    multiple, pad ``n_fft`` zeros on both edges, frame left-aligned,
    window, rFFT.  x: (nsampl,).  Returns (F, n_frames) complex128."""
    x = np.asarray(x, np.float64)
    nsampl = len(x)
    n_blocks = int(np.ceil(nsampl / hop))
    x = np.concatenate([np.zeros(n_fft), x,
                        np.zeros(n_blocks * hop - nsampl), np.zeros(n_fft)])
    n_frames = 1 + (len(x) - n_fft) // hop
    out = np.empty((n_fft // 2 + 1, n_frames), dtype=np.complex128)
    for i in range(n_frames):
        out[:, i] = np.fft.rfft(x[i * hop : i * hop + n_fft] * window)
    return out


def ref_istft(spec, n_fft, hop, window, nsampl=None):
    """Inverse STFT without window-sum division, synthesis window scaled by
    ``2 / (n_fft / hop)``, then ``n_fft`` trimmed from both ends
    (util.py:48-169, 203-226).  spec: (F, n_frames).  Returns float64."""
    syn = np.asarray(window, np.float64) * (2.0 / (n_fft / hop))
    n_frames = spec.shape[1]
    y = np.zeros(n_fft + hop * (n_frames - 1), dtype=np.float64)
    for i in range(n_frames):
        y[i * hop : i * hop + n_fft] += syn * np.fft.irfft(spec[:, i], n=n_fft)
    y = y[n_fft : len(y) - n_fft]
    if nsampl is not None:
        y = y[:nsampl]
    return y


def numpy_forward(params, config, x):
    """DR-NMF forward pass with dense U and S.

    x: (T, F) or (B, T, F) magnitudes.  Returns (hidden (…, T, 2r),
    irm (…, T, F)) with the batch axis only when ``x`` had one.  No step
    masking: every frame is treated as valid."""
    K = config.K_layers
    p = {k: np.asarray(v, np.float64) for k, v in params.items()}
    x = np.asarray(x, np.float64)
    single = x.ndim == 2
    if single:
        x = x[None]

    def name(base, k):
        return f"{base}_{k}" if base in config.params_untied else base

    def dhat(k):
        d = np.exp(p[name("log_D", k)])
        return d / np.sqrt(np.sum(d**2, axis=0, keepdims=True))

    U = [np.exp(p["log_U1"]).T] + [np.exp(p["log_Uk"]).T] * (K - 1)
    n2r = config.hidden_dim
    S = {}
    for k in range(1, K):
        dk = dhat(k)
        alph = np.exp(p[name("log_alph", k)])
        S[k] = (np.eye(n2r) - (dk / alph).T @ dk).T
    W = [dhat(k) / np.exp(p[name("log_alph", k)]) for k in range(K)]
    b = [-np.ones(n2r) * np.exp(p[name("log_lam1", k)])
         / np.exp(p[name("log_alph", k)]) for k in range(K)]

    bsz, T, _ = x.shape
    h = np.broadcast_to(np.log1p(np.exp(p["log_h0"])), (bsz, n2r))
    hs = np.zeros((bsz, T, n2r))
    for t in range(T):
        hidden = None
        for k in range(K):
            pre = h @ U[k]
            if k > 0:
                pre = pre + hidden @ S[k]
            pre = pre + x[:, t] @ W[k]
            hidden = np.maximum(0.0, pre + b[k])
        h = hidden
        hs[:, t] = h

    clean = hs[..., : config.r] @ np.exp(p["log_W_clean"])
    noise = hs[..., config.r :] @ np.exp(p["log_W_noise"])
    irm = np.exp(np.log(EPS7 + clean) - np.log(EPS7 + clean + noise))
    if single:
        return hs[0], irm[0]
    return hs, irm


def numpy_enhance(params, config, signals, n_fft=512, hop=128):
    """Offline enhancement of equal-length signals: STFT, dense recurrence
    on the magnitudes, ratio mask applied to the complex spectrum, iSTFT.

    signals: (B, nsampl).  Returns (irm (B, T, F), enhanced (B, nsampl)),
    float64."""
    signals = np.atleast_2d(np.asarray(signals, np.float64))
    window = sqrt_hann(n_fft)
    specs = np.stack([ref_stft(s, n_fft, hop, window).T for s in signals])
    _, irm = numpy_forward(params, config, np.abs(specs))
    nsampl = signals.shape[1]
    out = np.stack([ref_istft((specs[i] * irm[i]).T, n_fft, hop, window,
                              nsampl=nsampl) for i in range(len(signals))])
    return irm, out


def numpy_sparse_nmf(v, w, h, beta, sparsity, max_iter, w_ind=None,
                     h_ind=None, conv_eps=0.0):
    """Sparse NMF multiplicative updates from a given initialization.

    Returns (w, h, divs, costs), float64."""
    v = v.astype(np.float64)
    w = w.astype(np.float64).copy()
    h = h.astype(np.float64).copy()
    r = w.shape[1]
    if w_ind is None:
        w_ind = np.ones(r, bool)
    if h_ind is None:
        h_ind = np.ones(r, bool)
    sparsity = np.broadcast_to(np.asarray(sparsity, np.float64), h.shape)

    wn = np.sqrt(np.sum(w**2, axis=0))
    w = w / wn
    h = h * wn[:, None]

    if beta != 2:
        v = v.copy()
        v[v == 0] = v[v > 0].min()

    lam = np.maximum(w @ h, FLR)
    divs, costs = [], []
    last_cost = np.inf
    for it in range(max_iter):
        if h_ind.any():
            if beta == 1:
                dph = np.maximum(np.sum(w[:, h_ind], axis=0)[:, None]
                                 + sparsity[h_ind], FLR)
                dmh = w[:, h_ind].T @ (v / lam)
            elif beta == 2:
                dph = np.maximum(w[:, h_ind].T @ lam + sparsity[h_ind], FLR)
                dmh = w[:, h_ind].T @ v
            else:
                dph = np.maximum(w[:, h_ind].T @ lam ** (beta - 1)
                                 + sparsity[h_ind], FLR)
                dmh = w[:, h_ind].T @ (v * lam ** (beta - 2))
            h[h_ind] = h[h_ind] * dmh / dph
            lam = np.maximum(w @ h, FLR)
        if w_ind.any():
            hw = h[w_ind].T
            ww = w[:, w_ind]
            if beta == 1:
                a = (v / lam) @ hw
                bb = np.sum(h[w_ind], axis=1)[None, :]
                dpw = np.maximum(bb + np.sum(a * ww, axis=0)[None, :] * ww, FLR)
                dmw = a + np.sum(bb * ww, axis=0)[None, :] * ww
            else:
                a = (v * lam ** (beta - 2)) @ hw if beta != 2 else v @ hw
                bb = lam ** (beta - 1) @ hw if beta != 2 else lam @ hw
                dpw = np.maximum(bb + np.sum(a * ww, axis=0)[None, :] * ww, FLR)
                dmw = a + np.sum(bb * ww, axis=0)[None, :] * ww
            w[:, w_ind] = ww * dmw / dpw
            w = w / np.sqrt(np.sum(w**2, axis=0))
            lam = np.maximum(w @ h, FLR)

        if beta == 1:
            div = np.sum(v * np.log(v / lam) - v + lam)
        elif beta == 2:
            div = np.sum((v - lam) ** 2)
        elif beta == 0:
            div = np.sum(v / lam - np.log(v / lam) - 1)
        else:
            div = np.sum(v**beta + (beta - 1) * lam**beta
                         - beta * v * lam ** (beta - 1)) / (beta * (beta - 1))
        cost = div + np.sum(sparsity * h)
        divs.append(div)
        costs.append(cost)
        if (it > 0 and conv_eps > 0
                and abs(cost - last_cost) / last_cost < conv_eps):
            break
        last_cost = cost
    return w, h, np.array(divs), np.array(costs)
