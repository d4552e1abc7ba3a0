"""Array-backend shim: the codec core runs identically under numpy (host
fallback, small buffers, tests) and jax.numpy (jit/device path).

Only the handful of primitives that differ between the two APIs live here;
everything else in ops/ is written against ``B.xp``.
"""
import os as _os

import numpy as _np


class NumpyBackend:
    name = "numpy"
    xp = _np

    @staticmethod
    def cummax(a, axis):
        return _np.maximum.accumulate(a, axis=axis)

    @staticmethod
    def cummin_rev(a, axis):
        """Reverse (suffix) cumulative minimum along axis."""
        return _np.flip(_np.minimum.accumulate(_np.flip(a, axis), axis=axis), axis)

    @staticmethod
    def cumsum_u32(a, axis=None):
        # numpy would promote uint32 sums to uint64; keep u32 wrap semantics
        return _np.cumsum(a, axis=axis, dtype=_np.uint32)

    @staticmethod
    def scatter_add_u32(target_len, idx1, c1, idx2, c2):
        out = _np.zeros(target_len, dtype=_np.uint32)
        _np.add.at(out, idx1, c1)
        _np.add.at(out, idx2, c2)
        return out

    @staticmethod
    def prefix_compose(maps):
        """Inclusive prefix composition of int32 maps [N, K]:
        out[b] = maps[b] ∘ maps[b-1] ∘ ... ∘ maps[0] (applied right-to-left),
        i.e. out[b][i] = maps[b][ out[b-1][i] ].  Log-doubling."""
        P = maps.copy()
        n = P.shape[0]
        s = 1
        while s < n:
            P[s:] = _np.take_along_axis(P[s:], P[:-s], axis=-1)
            s *= 2
        return P


# Fallback persistent-compilation-cache directory: one fixed path inside
# the checkout (listed in .gitignore).  The path is part of the cache key,
# so it must not move between runs.
DEFAULT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def configure_compile_cache():
    """Point JAX's persistent compilation cache at its directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
    is set here; otherwise the cache lives at DEFAULT_CACHE_DIR.  Returns
    the directory in use.  Encode/decode programs specialise on (config,
    chunk shape), so caching across processes amortises their compiles."""
    import jax

    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    env = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


class JaxBackend:
    name = "jax"

    def __init__(self):
        import jax
        import jax.numpy as jnp

        configure_compile_cache()
        self._jax = jax
        self.xp = jnp

    def cummax(self, a, axis):
        return self._jax.lax.cummax(a, axis=axis % a.ndim)

    def cummin_rev(self, a, axis):
        return self._jax.lax.cummin(a, axis=axis % a.ndim, reverse=True)

    def cumsum_u32(self, a, axis=None):
        return self.xp.cumsum(a, axis=axis, dtype=self.xp.uint32)

    def scatter_add_u32(self, target_len, idx1, c1, idx2, c2):
        out = self.xp.zeros(target_len, dtype=self.xp.uint32)
        out = out.at[idx1].add(c1, indices_are_sorted=True, mode="drop")
        out = out.at[idx2].add(c2, indices_are_sorted=True, mode="drop")
        return out

    def prefix_compose(self, maps):
        # Hand-rolled log-doubling (Hillis-Steele) instead of
        # lax.associative_scan, whose odd/even concatenates compile slowly
        # at large N.
        jnp = self.xp
        n = maps.shape[0]
        P = maps
        idx = jnp.arange(n, dtype=jnp.int32)[:, None]
        s = 1
        while s < n:
            prev = jnp.pad(P[:-s], ((s, 0), (0, 0)))
            comp = jnp.take_along_axis(P, prev, axis=1)
            P = jnp.where(idx >= s, comp, P)
            s *= 2
        return P


NUMPY = NumpyBackend()
_JAX = None


def on_accelerator():
    """Whether JAX's default device is an accelerator (not the CPU); the
    device routes of encode and decode run only then.  A JAX that fails to
    start raises here."""
    import jax

    return jax.default_backend() != "cpu"


def jax_backend():
    global _JAX
    if _JAX is None:
        _JAX = JaxBackend()
    return _JAX
