"""The backend layer: one XLA path with no kernel-choosing options, no
Pallas, no platform branches; the compile-cache placement; and the chip
smoke test refusing to run without a GPU."""
import os
import pathlib
import re
import shutil
import subprocess
import sys

import jax
import pytest

from aux_ssm_tpu import config

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "aux_ssm_tpu"
RETIRED_OPTIONS = ["AUX_SSM_PALLAS", "AUX_SSM_FUSED_CSMC",
                   "AUX_SSM_FILTER_SCAN", "AUX_SSM_SCALAR_SCAN",
                   "AUX_SSM_FUSED_DRAWS", "AUX_SSM_FAST_TAKE",
                   "AUX_SSM_PLANE_SELECT"]


def _sources():
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "bench.py",
                                             ROOT / "chip_smoke.py"]
    return {f: f.read_text() for f in files}


@pytest.mark.parametrize("option", RETIRED_OPTIONS)
def test_retired_kernel_option_is_not_read(option):
    hits = [str(f) for f, text in _sources().items() if option in text]
    assert not hits, f"{option} still read in {hits}"


def test_stitch_draws_has_no_fused_mode(monkeypatch):
    """The 'fused' value of AUX_SSM_STITCH_DRAWS chose a kernel; it is
    refused now, and the XLA formulations remain."""
    from aux_ssm_tpu.kernels import pit
    for mode in ("joint", "unfused"):
        monkeypatch.setenv("AUX_SSM_STITCH_DRAWS", mode)
        assert pit._draws_mode() == mode
    monkeypatch.setenv("AUX_SSM_STITCH_DRAWS", "fused")
    with pytest.raises(ValueError):
        pit._draws_mode()


def test_no_pallas_interpret_or_platform_branch_in_sources():
    for f, text in _sources().items():
        assert "jax.experimental.pallas" not in text, f
        assert "interpret=" not in text, f
        assert not re.search(r"\.platform\s+in\s*\(", text), f
        assert "device_kind ==" not in text, f


def test_import_loads_no_pallas_module():
    code = ("import sys, pkgutil, importlib, aux_ssm_tpu\n"
            "for m in pkgutil.walk_packages(aux_ssm_tpu.__path__, "
            "'aux_ssm_tpu.'):\n"
            "    importlib.import_module(m.name)\n"
            "print(sorted(n for n in sys.modules if 'pallas' in n))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert config.enable_compile_cache() == str(tmp_path)
        # JAX reads the variable itself; the code sets no other directory.
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_to_fixed_path_in_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = config.enable_compile_cache()
        assert got == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
        assert config.enable_compile_cache() == got     # no per-call name
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text()


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"},
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
