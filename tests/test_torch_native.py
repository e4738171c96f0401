"""The port's host kernels and their device counterparts (maua_tpu_torch/native.py) and the emerging
convolutions (maua_tpu_torch/gan/models_experimental.py) against maua_tpu's.

The port builds its own copies of the C++ sources with g++ into maua_tpu_torch/_build/ at the first call; the
build is written under a temporary name and moved into place, so processes that build at once do not race.
Its OpenMP threads follow torch.get_num_threads() at each call.

maua_tpu's `inverse_conv_device` drops the centre tap's cross-channel terms (it computes a pixel's channels at
once from neighbours that still read 0 there), so it inverts only weights with a diagonal centre tap; the
port's resolves the centre as a triangular system. Against maua_tpu's device version the port is held on
diagonal centres, and on full masked weights against the host kernel (maua_tpu's misses by > 0.1 there).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu import native as JN
from maua_tpu.gan import models_experimental as JE
from maua_tpu_torch import native as TN
from maua_tpu_torch.gan import models_experimental as TE
from test_native import _forward_conv, _masked_weight

REPO = Path(__file__).resolve().parents[1]


def test_builds_into_the_package_and_reports_avx512():
    assert TN.available()
    path = TN.library_path()
    assert path.parent == REPO / "maua_tpu_torch" / "_build" and path.exists()
    assert isinstance(TN.simd_available(), bool)


def test_concurrent_builds_do_not_race(tmp_path):
    """Four processes build a fresh copy of the sources into one directory at once: each loads a whole library
    and computes the same quantile (a process reading a half-written file would fail to load it)."""
    import shutil

    pkg = tmp_path / "maua_tpu_torch"
    (pkg / "csrc").mkdir(parents=True)
    for s in TN.SOURCES:
        shutil.copy(TN.CSRC / s, pkg / "csrc" / s)
    shutil.copy(REPO / "maua_tpu_torch" / "native.py", pkg / "native.py")
    (pkg / "__init__.py").write_text("")
    code = ("import numpy as np\nfrom maua_tpu_torch import native\n"
            "print(native.efficient_quantile(np.arange(1001, dtype=np.float32), [0.5])[0])\n")
    env = {**os.environ, "PYTHONPATH": str(tmp_path)}
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=tmp_path, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert [o.strip() for o, _ in outs] == ["500.0"] * 4
    built = list((pkg / "_build").iterdir())
    assert len(built) == 1 and built[0].suffix == ".so"  # no temporary file left behind


def test_openmp_threads_follow_torch():
    """The library's OpenMP runtime is not PyTorch's: each call passes torch's thread count through."""
    import ctypes

    calls = []
    lib = TN._lib()
    real = lib.maua_native_set_threads
    lib.maua_native_set_threads = lambda n: calls.append(n) or real(ctypes.c_int(n))
    try:
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        TN.kthvalue(np.arange(10, dtype=np.float32), 3)
        torch.set_num_threads(before)
    finally:
        lib.maua_native_set_threads = real
    assert calls == [1]


@pytest.mark.parametrize("ignore_nan", [False, True])
def test_efficient_quantile_matches_maua_tpu(ignore_nan):
    rs = np.random.RandomState(0)
    x = rs.randn(100_000).astype(np.float32)
    if ignore_nan:
        x[::10] = np.nan
    qs = [0.0, 0.01, 0.25, 0.5, 0.75, 0.95, 0.99, 1.0]
    got = TN.efficient_quantile(torch.from_numpy(x), qs, ignore_nan=ignore_nan)
    assert np.allclose(got, JN.efficient_quantile(x, qs, ignore_nan=ignore_nan), atol=1e-6, rtol=0)
    plain = (np.nanquantile if ignore_nan else np.quantile)(x, qs)
    assert np.allclose(got, plain, atol=1e-5)


def test_kthvalue_matches_maua_tpu():
    x = np.random.RandomState(2).randn(997).astype(np.float32)
    for k in (1, 10, 500, 997):
        assert TN.kthvalue(x, k) == JN.kthvalue(x, k) == float(np.partition(x, k - 1)[k - 1])
    with pytest.raises(ValueError):
        TN.kthvalue(x, 0)


@pytest.mark.parametrize("is_upper", [False, True])
@pytest.mark.parametrize("dilation", [1, 2])
def test_inverse_conv_matches_maua_tpu_and_inverts(is_upper, dilation):
    rs = np.random.RandomState(3 + dilation)
    w = _masked_weight(rs, 3, 3, is_upper)
    x = rs.randn(2, 7, 6, 3).astype(np.float32)
    z = rs.randn(2, 7, 6, 3).astype(np.float32)
    got = TN.inverse_conv(z, w, is_upper=is_upper, dilation=dilation)
    assert np.abs(got - JN.inverse_conv(z, w, is_upper=is_upper, dilation=dilation)).max() <= 1e-6
    assert np.abs(got - TN._inverse_conv_py(z, w, is_upper, dilation)).max() <= 1e-5
    if dilation == 1:  # a round trip through the forward conv
        assert np.abs(TN.inverse_conv(_forward_conv(x, w), w, is_upper=is_upper) - x).max() < 1e-5


def test_quantile_device_matches_maua_tpus_device_version():
    rs = np.random.RandomState(5)
    for n, qs in ((1000, [0.25, 0.75]), (4097, [0.0, 0.001, 0.5, 0.999, 1.0]), (7, 0.3)):
        x = rs.randn(n).astype(np.float32)
        got = TN.quantile_device(torch.from_numpy(x), qs).numpy()
        assert np.allclose(got, np.asarray(JN.quantile_device(x, qs)), atol=1e-6, rtol=0)
        assert np.allclose(got, np.quantile(x, qs), atol=1e-5)
    x[3] = np.nan
    assert np.isnan(TN.quantile_device(torch.from_numpy(x), 0.5)) and np.isnan(JN.quantile_device(x, 0.5))


@pytest.mark.parametrize("is_upper", [False, True])
def test_inverse_conv_device(is_upper):
    rs = np.random.RandomState(6)
    w = _masked_weight(rs, 3, 3, is_upper)
    x = rs.randn(1, 5, 6, 3).astype(np.float32)
    diag = w.copy()
    diag[1, 1] = np.diag(np.diag(w[1, 1]))  # a diagonal centre tap: maua_tpu's device version is exact there
    z = _forward_conv(x, diag)
    got = TN.inverse_conv_device(torch.from_numpy(z), torch.from_numpy(diag), is_upper).numpy()
    assert np.abs(got - np.asarray(JN.inverse_conv_device(z, diag, is_upper))).max() <= 1e-6
    z = _forward_conv(x, w)
    for dilation in (1, 2):
        got = TN.inverse_conv_device(torch.from_numpy(z), torch.from_numpy(w), is_upper, dilation).numpy()
        assert np.abs(got - TN.inverse_conv(z, w, is_upper, dilation)).max() <= 1e-6
    assert np.abs(TN.inverse_conv_device(torch.from_numpy(z), torch.from_numpy(w), is_upper).numpy() - x).max() < 1e-5
    assert np.abs(np.asarray(JN.inverse_conv_device(z, w, is_upper)) - x).max() > 0.1  # maua_tpu's misses


@pytest.mark.parametrize("is_upper", [False, True])
def test_emerging_conv_matches_maua_tpu_and_inverts(is_upper):
    w_hwio = np.asarray(JE.masked_emerging_weight(jax.random.PRNGKey(4), 4, 3, is_upper))
    w = torch.from_numpy(w_hwio).permute(3, 2, 0, 1)  # the bridge's HWIO -> OIHW
    x = np.random.RandomState(7).randn(2, 9, 8, 4).astype(np.float32)
    z = TE.emerging_conv(torch.from_numpy(x).permute(0, 3, 1, 2), w)
    want = np.asarray(JE.emerging_conv(jnp.asarray(x), jnp.asarray(w_hwio)))
    assert np.abs(z.permute(0, 2, 3, 1).numpy() - want).max() <= 1e-5
    back = TE.emerging_conv_inverse(z, w, is_upper=is_upper)
    assert np.abs(back.permute(0, 2, 3, 1).numpy() - x).max() < 1e-4
    assert np.abs(back.permute(0, 2, 3, 1).numpy() - JE.emerging_conv_inverse(want, w_hwio, is_upper)).max() < 1e-4


@pytest.mark.parametrize("is_upper", [False, True])
def test_masked_emerging_weight_has_maua_tpus_structure(is_upper):
    w = TE.masked_emerging_weight(torch.Generator().manual_seed(0), 5, 3, is_upper)
    w_ref = np.asarray(JE.masked_emerging_weight(jax.random.PRNGKey(0), 5, 3, is_upper))
    ref = torch.from_numpy(w_ref).permute(3, 2, 0, 1)
    assert w.shape == ref.shape == (5, 5, 3, 3)
    assert torch.equal(w == 0, ref == 0)  # the same taps and the same centre triangle are masked
    d = torch.diagonal(w[:, :, 1, 1])
    assert bool(((d >= 1) & (d < 2)).all())
    x = torch.randn(1, 5, 6, 7, generator=torch.Generator().manual_seed(1))
    back = TE.emerging_conv_inverse(TE.emerging_conv(x, w), w, is_upper=is_upper)
    assert (back - x).abs().max() < 1e-4
