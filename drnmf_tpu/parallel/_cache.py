"""Small LRU cache for jitted shard_map programs.

The parallel scan entry points cache their compiled programs keyed on
(config, mesh devices, shapes): jax.jit keys on the callable's identity, so
building a fresh shard_map wrapper per call would recompile every
invocation.  The cache is
bounded so a long-lived process scanning many batch shapes does not
accumulate executables without bound.
"""

from collections import OrderedDict

_MAX_ENTRIES = 16


class CompiledCache:
    def __init__(self, max_entries=_MAX_ENTRIES):
        self._d = OrderedDict()
        self._max = max_entries

    def get(self, key):
        fn = self._d.get(key)
        if fn is not None:
            self._d.move_to_end(key)
        return fn

    def put(self, key, fn):
        self._d[key] = fn
        while len(self._d) > self._max:
            self._d.popitem(last=False)

    def __len__(self):
        return len(self._d)

    def clear(self):
        self._d.clear()
