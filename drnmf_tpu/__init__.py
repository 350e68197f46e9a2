"""drnmf_tpu: a JAX speech-enhancement framework, run on NVIDIA GPUs.

Reimplements the full capability surface of the DR-NMF reference system
(Deep Recurrent NMF for speech enhancement, WASPAA 2017, arXiv:1709.07124)
as an idiomatic JAX framework:

- ``dsp``      -- STFT / iSTFT signal primitives (reference: util.py)
- ``data``     -- datasets, featurization, sequence batching (reference: audio_dataset.py)
- ``ops``      -- sparse NMF multiplicative updates, ISTA
                  (reference: snmf.py + sparseNMF/sparse_nmf_gpu.m, enhance.py ISTA oracles)
- ``models``   -- DR-NMF unfolded-ISTA model, LSTM baseline, SNMF enhancer
                  (reference: custom_layers.py, enhance.py builders)
- ``train``    -- optax training loop, masked losses, checkpointing, history
                  (reference: enhance.py + custom_callbacks.py)
- ``metrics``  -- BSS-Eval SDR, SNR, segmental SNR, STOI, PESQ, on-device
                  (reference: score_audio.m + MATLAB toolboxes)
- ``parallel`` -- device-mesh sharding helpers (jax.sharding / collectives)
- ``streaming``-- online chunk-by-chunk enhancement (bounded-latency serving)
- ``utils``    -- config hashing, artifact caching, profiling, reporting
- ``reference``-- plain float64 numpy reference the tests and chip_smoke.py
                  hold the device code to
"""

__version__ = "0.1.0"

from .streaming import StreamingEnhancer, MultiStreamEnhancer

__all__ = ["StreamingEnhancer", "MultiStreamEnhancer", "__version__"]
