"""Compilation settings shared by the tools, the benchmark and the smoke
run: XLA's compile-effort knob and the persistent compilation cache.

Compile effort. XLA exposes a documented effort scale via compiler
options; ``exec_time_optimization_effort=-1.0`` compiles the full
encode graph several times faster at some cost in run time. Sub-zero
effort is therefore never the default for throughput paths (bench,
batch_tool); the single-file CLI tools, where cold latency is what the
user waits for, pass default="lo".

Env: ULCX_COMPILE_EFFORT
  unset / ""     -> the caller's default (None = XLA default effort)
  "default"      -> None (force XLA default, overriding a caller's lo)
  "lo"           -> exec_time_optimization_effort = -1.0
  "hi"           -> +1.0
  a float string -> that value

Compilation cache. ``JAX_COMPILATION_CACHE_DIR`` when set, else the
fixed directory ``<repo>/.jax_cache`` (a fixed path, because the path
is part of the cache key).
"""

from __future__ import annotations

import os

_NAMED = {"lo": -1.0, "hi": 1.0}
_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def jit_options(default: str | None = None) -> dict | None:
    """compiler_options dict for jax.jit, or None for XLA defaults."""
    v = os.environ.get("ULCX_COMPILE_EFFORT", "").strip() or (default or "")
    if not v or v == "default":
        return None
    effort = _NAMED.get(v)
    if effort is None:
        try:
            effort = float(v)
        except ValueError:
            raise ValueError(
                f"ULCX_COMPILE_EFFORT={v!r}: use 'lo', 'hi', or a float"
            ) from None
    return {"exec_time_optimization_effort": effort}


def compile_cache_dir() -> str:
    """Where compiled programs persist across processes."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _REPO, ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir()
    and return that directory."""
    import jax

    d = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return d
