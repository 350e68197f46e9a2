from .config import config_hash, load_yaml, dump_yaml, ensure_experiment_dirs
from .cache import snmf_cache_path, save_snmf, load_snmf
from .profiling import (StageTimer, trace, device_sync, enable_compile_cache,
                        default_compile_cache_dir)

__all__ = [
    "config_hash",
    "load_yaml",
    "dump_yaml",
    "ensure_experiment_dirs",
    "snmf_cache_path",
    "save_snmf",
    "load_snmf",
    "StageTimer",
    "trace",
    "device_sync",
    "enable_compile_cache",
    "default_compile_cache_dir",
]
