"""Device gate, GPU lowering of the kernels, and compile-cache placement.

The Triton-route kernels cannot compile here (no GPU), but their
lowering to the Triton IR runs on the CPU: an unsupported primitive or
a non-power-of-two load shows up as a lowering error before the code
ever reaches a card.
"""

import functools
import pathlib

import jax
import jax.numpy as jnp
import pytest

from ulcx.bitstream import pallas_decode as pd
from ulcx.bitstream import pallas_encode3 as pe3
from ulcx.utils.config import CodecConfig, kernel_mode

REPO = pathlib.Path(__file__).resolve().parents[1]


def _encode_args(p_tot, g=2, lanes=pe3.LANES):
    i32, f32 = jnp.int32, jnp.float32
    cand = jax.ShapeDtypeStruct((g, pe3.N_CAND, lanes), i32)
    pos = lambda dt: jax.ShapeDtypeStruct((g, p_tot, 1, lanes), dt)
    line = lambda dt: jax.ShapeDtypeStruct((g, p_tot // 2, 1, lanes), dt)
    state = jax.ShapeDtypeStruct((g, p_tot, pe3.N_CAND, lanes), i32)
    return cand, pos, line, state, i32, f32


def _kernels(p_tot):
    cand, pos, line, state, i32, f32 = _encode_args(p_tot)
    g, lanes, t_len = 2, pd.LANES, 2 * p_tot
    return {
        "zone_scan_and_backfill": (
            lambda t, c, k, cf, th, ax: pe3.p12_call(t, c, k, cf, th, ax, p_tot),
            (cand, cand, pos(i32), pos(f32), pos(i32), pos(i32)),
        ),
        "emission_size": (
            lambda th, ax, st: pe3.p3_call(
                None, th, None, ax, None, None, st, None, p_tot, False
            ),
            (pos(i32), pos(i32), state),
        ),
        "emission_materialize": (
            lambda cf, an, ax, ha, hm, st, hd: pe3.p3_call(
                cf, None, an, ax, ha, hm, st, hd, p_tot, True
            ),
            (pos(f32), line(f32), pos(i32), line(f32), line(i32), state, cand),
        ),
        "token_fsm": (
            functools.partial(pd.fsm_kernel_call, p_tot=p_tot, n=p_tot // 2),
            (
                jax.ShapeDtypeStruct((g, lanes), i32),
                jax.ShapeDtypeStruct((g, t_len, lanes), i32),
            ),
        ),
        "rng_expand": (
            functools.partial(pd.rng_expand_kernel_call, p_tot=p_tot),
            (
                jax.ShapeDtypeStruct((g, p_tot, lanes), i32),
                jax.ShapeDtypeStruct((g, lanes), jnp.uint32),
            ),
        ),
    }


@pytest.mark.parametrize("p_tot", [512, 32768])
@pytest.mark.parametrize("name", list(_kernels(512)))
def test_kernel_lowers_for_cuda(name, p_tot):
    """Each kept kernel lowers through the Triton route for the GPU, at
    the bottom and the top of the P envelope."""
    fn, args = _kernels(p_tot)[name]
    lowered = jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",))
    assert "__gpu$xla.gpu.triton" in lowered.as_text()


@pytest.mark.parametrize(
    "backend, use_pallas, want",
    [
        ("gpu", "auto", "compiled"),
        ("gpu", "on", "compiled"),
        ("gpu", "off", "off"),
        ("cpu", "auto", "off"),
        ("cpu", "on", "interpret"),
        ("cpu", "off", "off"),
    ],
)
def test_kernel_mode(monkeypatch, backend, use_pallas, want):
    """gpu compiles the kernels, cpu takes the scan path unless a caller
    asks for the interpreted kernels; nothing on gpu interprets."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=2048,
                      use_pallas=use_pallas)
    assert kernel_mode(cfg) == want


@pytest.mark.parametrize("backend", ["rocm", "METAL", "neuron"])
def test_kernel_mode_rejects_other_backends(monkeypatch, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    for use_pallas in ("auto", "on", "off"):
        cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=2048,
                          use_pallas=use_pallas)
        with pytest.raises(RuntimeError, match="GPU or on the CPU"):
            kernel_mode(cfg)


def test_kernel_mode_envelope(monkeypatch):
    """Past P = 32768 the GPU takes the scan path; a forced 'on' raises."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    big = CodecConfig(rate_hz=44100, n_chan=4, block_size=16384)
    assert kernel_mode(big) == "off"
    top = CodecConfig(rate_hz=44100, n_chan=1, block_size=32768)
    assert kernel_mode(top) == "compiled"
    with pytest.raises(ValueError, match="outside the kernel envelope"):
        kernel_mode(CodecConfig(rate_hz=44100, n_chan=4, block_size=16384,
                                use_pallas="on"))


def test_pallas_imports_name_gpu_routes_only():
    """Every Pallas import in the repository is the generic API or the
    Triton route: no module pulls in another accelerator's dialect."""
    import ast

    allowed = {"jax.experimental.pallas", "jax.experimental.pallas.triton"}
    found = set()
    for path in REPO.glob("**/*.py"):
        if not {"ulcx", "tests", "devtools"} & set(path.parts) and path.parent != REPO:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module:
                mods = [f"{node.module}.{a.name}" for a in node.names]
            elif isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            else:
                continue
            found |= {m for m in mods if m.startswith("jax.experimental.pallas")}
    assert found and found <= allowed, found - allowed


@pytest.mark.parametrize("env", [None, "custom"])
def test_compile_cache_placement(monkeypatch, tmp_path, env):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits
    at the fixed <repo>/.jax_cache."""
    from ulcx.utils.compileopts import enable_compile_cache

    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = str(REPO / ".jax_cache")
    else:
        want = str(tmp_path / env)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
