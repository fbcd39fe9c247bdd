"""The import guard: a run of the port must not have loaded JAX or the
JAX package.  Names are compared by their top-level part whole, so
``repro_torch`` is not ``repro``."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def check(when: str, loaded_before=()) -> None:
    """Exit with code 3, naming what was loaded, if a forbidden module is
    in ``sys.modules``, other than ``loaded_before`` (modules a test's own
    process held before it drove a run in-process; a run of the benchmark
    passes none)."""
    found = sorted(set(forbidden_modules()) - set(loaded_before))
    if found:
        print(f"nspubench: forbidden modules loaded {when}: {', '.join(found)}",
              file=sys.stderr, flush=True)
        raise SystemExit(3)
