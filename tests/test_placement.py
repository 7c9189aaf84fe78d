"""Device placement, backend start-up, compile cache and the chip smoke
script's contract — all checkable without an accelerator."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import pytest

from ema_tpu.core import pipeline
from ema_tpu.utils import backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIG = pipeline.DEVICE_FM_MIN_OCC_BYTES + 1
SMALL = pipeline.DEVICE_FM_MIN_OCC_BYTES


@pytest.fixture
def clean_env(monkeypatch):
    monkeypatch.delenv("EMA_TPU_SW_IMPL", raising=False)
    monkeypatch.delenv("EMA_TPU_SEED_IMPL", raising=False)


class TestPlacement:
    def test_cpu_backend_keeps_every_stage_on_host(self, clean_env):
        for occ in (SMALL, BIG):
            pl = pipeline.resolve_placement(occ)
            assert not pipeline.on_accelerator()
            assert pl.sw == "native" and pl.host_fm
            assert (pl.batch_size, pl.inflight_chunks) == (2048, 5)

    @pytest.mark.parametrize("occ,host_fm", [(SMALL, True), (BIG, False)])
    def test_gpu_backend_puts_sw_on_device(self, clean_env, monkeypatch,
                                           occ, host_fm):
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert pipeline.on_accelerator()
        pl = pipeline.resolve_placement(occ)
        assert pl.sw == "banded"
        # locate/greedy seeding follow the occ-size rule
        assert pl.host_fm == host_fm
        assert (pl.batch_size, pl.inflight_chunks) == (4096, 4)

    def test_env_overrides(self, monkeypatch):
        monkeypatch.setenv("EMA_TPU_SW_IMPL", "banded")
        monkeypatch.setenv("EMA_TPU_SEED_IMPL", "device")
        pl = pipeline.resolve_placement(SMALL)
        assert pl.sw == "banded" and not pl.host_fm
        monkeypatch.setenv("EMA_TPU_SW_IMPL", "banded_pallas")  # gone
        assert pipeline.resolve_placement(SMALL).sw == "native"


class TestBackend:
    def test_init_error_propagates(self, monkeypatch):
        def boom(*a, **k):
            raise RuntimeError("Unable to initialize backend 'cuda'")

        monkeypatch.setattr(jax, "devices", boom)
        with pytest.raises(RuntimeError, match="cuda"):
            backend.ensure_backend()

    def test_cache_dir_from_env(self, monkeypatch, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert backend.compile_cache_dir() == str(tmp_path)

    def test_cache_dir_default_is_fixed_in_checkout(self, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        a, b = backend.compile_cache_dir(), backend.compile_cache_dir()
        assert a == b == os.path.join(REPO, ".jax_cache")
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


class TestChipSmoke:
    def test_contract_line_exact_keys(self):
        import chip_smoke

        line = chip_smoke.contract_line("gpu", "NVIDIA H100 80GB HBM3", 1)
        assert json.loads(line) == {"ok": True, "device": {
            "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}

    def test_contract_line_refuses_cpu(self):
        import chip_smoke

        with pytest.raises(ValueError):
            chip_smoke.contract_line("cpu", "cpu", 1)

    def test_import_does_not_start_a_backend(self):
        code = ("import sys; sys.path.insert(0, '.'); import chip_smoke; "
                "import jax._src.xla_bridge as xb; "
                "print(len(xb._backends))")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, check=True)
        assert out.stdout.strip() == "0"


def _dtypes(closed):
    """Every dtype a jaxpr's equations produce, nested jaxprs included."""
    out, todo = set(), [closed.jaxpr]
    while todo:
        j = todo.pop()
        for e in j.eqns:
            out.update(str(v.aval.dtype) for v in e.outvars)
            for p in e.params.values():
                sub = getattr(p, "jaxpr", None)
                if sub is not None:
                    todo.append(getattr(sub, "jaxpr", sub))
    return out


def test_device_programs_stay_32bit_without_x64():
    """The CLI runs without x64 (the EM scopes it to its own dispatch),
    so the SW and FM programs carry no 64-bit values; with x64 on
    globally XLA would widen some of their intermediates."""
    import jax.numpy as jnp
    import numpy as np

    from ema_tpu.index import build_index, fmindex

    idx = build_index({"c": np.random.default_rng(0).integers(
        0, 4, 5000).astype(np.uint8)})
    B, L = 16, 150
    with jax.enable_x64(False):
        fma = fmindex.FMIndexArrays.from_index(idx)
        i32 = jnp.zeros(B, jnp.int32)
        sw = jax.make_jaxpr(lambda *a: pipeline._gather_score(
            *a, w_max=256, w_band=128, match=1, mismatch=4, gap_open=6,
            gap_extend=1, clip=5))(
            jnp.zeros(5000, jnp.uint8), jnp.zeros((B, L), jnp.uint8),
            i32, i32, i32, i32, i32)
        loc = jax.make_jaxpr(lambda r: fmindex.locate(fma, r))(i32)
        seed = jax.make_jaxpr(lambda r, n: fmindex.seed_locate_reads(
            fma, r, n, budget=256))(jnp.zeros((B, L), jnp.uint8), i32)
    for name, j in (("sw", sw), ("locate", loc), ("seed", seed)):
        wide = _dtypes(j) & {"int64", "uint64", "float64"}
        assert not wide, (name, wide)
