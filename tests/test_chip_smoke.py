"""The chip smoke test's device gate and the compile-cache choice: what
decides where the program runs and what it keeps between processes."""

import importlib.util
import os
from types import SimpleNamespace

import jax
import pytest

from snakeslam_tpu import compile_cache_dir
from snakeslam_tpu.utils.device import check_gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dev(platform):
    return SimpleNamespace(platform=platform, device_kind=platform)


@pytest.mark.parametrize("devices,count,ok", [
    ([_dev("cpu")] * 8, 1, False),
    ([], 1, False),
    ([_dev("gpu")], 1, True),
    ([_dev("gpu")] * 4, 4, True),
    ([_dev("gpu")] * 2, 4, False),
])
def test_check_gpu(devices, count, ok):
    if ok:
        check_gpu(devices, count)
    else:
        with pytest.raises(RuntimeError):
            check_gpu(devices, count)


def test_chip_smoke_fails_on_cpu_and_prints_no_result(capsys):
    """On this CPU-only test backend chip_smoke stops at its device phase:
    it raises before any other phase and never prints the JSON result."""
    assert jax.devices()[0].platform == "cpu"
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("environ,want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/some/cache"}, None),
    ({"JAX_COMPILATION_CACHE_DIR": "/some/cache", "JAX_PLATFORMS": "cuda"},
     None),
    ({}, os.path.join(REPO, ".jax_cache")),
    ({"JAX_PLATFORMS": "cuda"}, os.path.join(REPO, ".jax_cache")),
    ({"JAX_PLATFORMS": "cpu"}, None),
])
def test_compile_cache_dir(environ, want):
    """JAX_COMPILATION_CACHE_DIR wins (nothing set in code); otherwise the
    fixed <repo>/.jax_cache, except on CPU-only runs."""
    assert compile_cache_dir(environ) == want
