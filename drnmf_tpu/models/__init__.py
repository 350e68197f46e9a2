from .drnmf import (
    DRNMFConfig,
    init_drnmf_params,
    drnmf_apply,
    drnmf_trainable_mask,
    flagship,
)
from .lstm import LSTMConfig, init_lstm_params, lstm_apply
from .snmf_enhancer import snmf_infer_irm

__all__ = [
    "DRNMFConfig",
    "init_drnmf_params",
    "drnmf_apply",
    "drnmf_trainable_mask",
    "flagship",
    "LSTMConfig",
    "init_lstm_params",
    "lstm_apply",
    "snmf_infer_irm",
]
