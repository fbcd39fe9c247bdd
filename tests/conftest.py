"""Test-suite bootstrap: the ``compile_counter`` fixture and a tiny
vendored ``hypothesis`` shim.

Several test modules hard-import ``hypothesis``; the container does not ship
it and nothing may be pip-installed.  Instead of skipping those modules (and
losing their coverage), we register a minimal drop-in shim into
``sys.modules`` *before collection* that supports exactly the API surface the
suite uses:

  @settings(max_examples=N, deadline=None)
  @given(x=st.integers(a, b), y=st.floats(a, b), z=st.sampled_from(seq))
  def test_...(x, y, z): ...

The shim draws ``max_examples`` pseudo-random examples per test from a
deterministic per-test seed (derived from the test name), so runs are
reproducible.  There is no shrinking and no example database — it is a test
*runner*, not a property-based testing engine.  If the real ``hypothesis``
is installed it is used untouched.
"""
from __future__ import annotations

import contextlib
import functools
import random
import sys
import types
import zlib

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card with CUDA; skips on hosts without one",
    )


class CompileCounter:
    """Counts real XLA compilations and jit trace-cache growth.

    ``compiles`` / ``names`` record every module that went through
    ``jax._src.compiler.backend_compile`` — the one funnel below
    ``jit``/``lower().compile()`` that persistent-cache HITS skip, so it
    counts true compilation work, not tracing.  ``named(substr)`` filters
    by HLO module name (e.g. ``'fit_scan_padded'``), which keeps
    assertions robust against incidental helper modules (conversions,
    broadcasts) the runtime compiles on the side.  ``expect_traces``
    pins the *tracing* side via a jitted callable's ``_cache_size()``.
    """

    def __init__(self):
        self.compiles = 0
        self.names: list[str] = []

    def named(self, substr: str) -> int:
        return sum(1 for n in self.names if substr in n)

    @staticmethod
    def traces(fn) -> int:
        return fn._cache_size()

    @contextlib.contextmanager
    def expect_traces(self, fn, n: int):
        before = fn._cache_size()
        yield
        got = fn._cache_size() - before
        assert got == n, (
            f"expected exactly {n} new trace(s) of "
            f"{getattr(fn, '__name__', fn)}, got {got}"
        )


@pytest.fixture
def compile_counter(monkeypatch, tmp_path):
    """Intercept compilation at the jax.jit / AOT lower seam.

    Every trace-count / compile-count assertion in the suite goes through
    this fixture — one seam, one contract.  Both persistence layers — the
    JAX compilation cache AND the serialized-AOT-executable store keyed
    off ``backend.compile_cache_dir()`` — are pointed at a throwaway
    per-test directory for the fixture's lifetime, so counts are
    deterministic regardless of whether the environment (e.g. CI) runs
    the suite with a warm ``REPRO_COMPILE_CACHE``.
    """
    import jax
    from jax._src import compiler as _compiler
    from repro.core import backend as _backend

    counter = CompileCounter()
    orig = _compiler.backend_compile

    def spy(backend, module, *args, **kwargs):
        try:
            name = str(module.operation.attributes["sym_name"])
        except Exception:
            name = str(getattr(module, "name", ""))
        counter.compiles += 1
        counter.names.append(name)
        return orig(backend, module, *args, **kwargs)

    monkeypatch.setattr(_compiler, "backend_compile", spy)
    monkeypatch.setattr(
        _backend, "_compile_cache_path", str(tmp_path / "jaxcache")
    )
    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", str(tmp_path / "jaxcache"))
    try:
        yield counter
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


try:  # real hypothesis wins if present
    import hypothesis  # noqa: F401
except ImportError:
    _MODULE = "hypothesis"

    class _Strategy:
        def __init__(self, draw):
            self._draw = draw

        def example_from(self, rng: random.Random):
            return self._draw(rng)

    def integers(min_value, max_value):
        return _Strategy(lambda rng: rng.randint(min_value, max_value))

    def floats(min_value, max_value):
        return _Strategy(lambda rng: rng.uniform(min_value, max_value))

    def sampled_from(elements):
        seq = list(elements)
        return _Strategy(lambda rng: seq[rng.randrange(len(seq))])

    def given(**strategies):
        def decorate(fn):
            @functools.wraps(fn)
            def runner():  # zero-arg: examples are drawn, not fixtures
                cfg = getattr(runner, "_shim_settings", {})
                n = cfg.get("max_examples", 10)
                seed = zlib.adler32(fn.__qualname__.encode())
                rng = random.Random(seed)
                for _ in range(n):
                    kwargs = {
                        name: s.example_from(rng)
                        for name, s in strategies.items()
                    }
                    try:
                        fn(**kwargs)
                    except Exception as e:  # surface the failing example
                        raise AssertionError(
                            f"falsifying example ({fn.__name__}): {kwargs}"
                        ) from e

            # pytest resolves fixtures from inspect.signature, which follows
            # __wrapped__ back to fn's (example-)parameters — drop it.
            del runner.__wrapped__
            return runner

        return decorate

    def settings(**kwargs):
        def decorate(fn):
            fn._shim_settings = kwargs
            return fn

        return decorate

    shim = types.ModuleType(_MODULE)
    shim.given = given
    shim.settings = settings
    shim.__version__ = "0.0-shim"
    strategies_mod = types.ModuleType(f"{_MODULE}.strategies")
    strategies_mod.integers = integers
    strategies_mod.floats = floats
    strategies_mod.sampled_from = sampled_from
    shim.strategies = strategies_mod
    sys.modules[_MODULE] = shim
    sys.modules[f"{_MODULE}.strategies"] = strategies_mod
