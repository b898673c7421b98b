"""The improve router, the compile-cache location and the SDR placement
policy — every decision made from what the code can observe."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import qcqp_tpu as qt
from qcqp_tpu import routing
from qcqp_tpu.solvers import sdp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, P, X, NW = routing.KERNEL, routing.PERCOORD, routing.XLA, routing.NEWTON


@pytest.mark.parametrize("platform,dtype,n,m,eq_static,cd", [
    ("cpu", np.float32, 100, 50, True, X),
    ("cpu", np.float64, 100, 50, True, X),
    ("cpu", np.float32, 7, 3, False, X),
    ("gpu", np.float32, 100, 50, True, K),
    ("gpu", np.float32, 100, 50, False, P),
    ("gpu", np.float32, 128, 127, True, K),
    ("gpu", np.float32, 129, 10, True, P),
    ("gpu", np.float32, 100, 128, True, P),
    ("gpu", np.float64, 100, 50, True, X),
    ("gpu", np.float64, 7, 3, False, X),
])
def test_improve_paths(platform, dtype, n, m, eq_static, cd):
    paths = routing.improve_paths(platform, dtype, n, m, eq_static)
    admm = NW if platform == "gpu" else X
    assert paths == {qt.COORD_DESCENT: cd, qt.ADMM: admm, qt.DCCP: X,
                     qt.IPOPT: X}


@pytest.mark.parametrize("path,trips", [(X, None), (NW, 6)])
def test_admm_proj_trips(path, trips):
    assert routing.admm_proj_trips(path) == trips


@pytest.mark.parametrize("platform", ["rocm", "metal", ""])
def test_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="no improve route"):
        routing.improve_paths(platform, np.float32, 10, 5, True)
    with pytest.raises(ValueError, match="no improve route"):
        routing.default_dtype(platform)


def test_default_dtype():
    assert routing.default_dtype("cpu") == np.float64
    assert routing.default_dtype("gpu") == np.float32


def test_form_paths_sees_traced_equality_pattern():
    """Inside an outer trace the equality pattern is abstract, so the GPU
    route falls back from the kernel to the per-coordinate path."""
    form = qt.make_form(np.zeros((3, 4, 4)), np.zeros((3, 4)), np.zeros(3),
                        np.array([True, False])).astype(jnp.float32)
    assert routing.form_paths(form, "gpu")[qt.COORD_DESCENT] == K
    seen = []

    def f(is_eq):
        seen.append(routing.form_paths(form._replace(is_eq=is_eq), "gpu"))
        return is_eq

    jax.jit(f)(form.is_eq)
    assert seen[0][qt.COORD_DESCENT] == P


def _cache_dir_in_fresh_process(env_value):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    out = subprocess.run(
        [sys.executable, "-c",
         "import qcqp_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_default_is_repo_dir():
    assert _cache_dir_in_fresh_process(None) == os.path.join(REPO,
                                                             ".jax_cache")


def test_compile_cache_follows_env(tmp_path):
    d = str(tmp_path / "cache")
    assert _cache_dir_in_fresh_process(d) == d


def test_compile_cache_dir_function(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert qt.compile_cache_dir() == os.path.join(REPO, ".jax_cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert qt.compile_cache_dir() == str(tmp_path)


# -- SDR placement under a GPU backend (monkeypatched) ----------------------

def _bls_form32(n=6):
    rng = np.random.default_rng(0)
    A = rng.standard_normal((n + 3, n))
    b = rng.standard_normal(n + 3)
    P = np.zeros((n + 1, n, n))
    P[0] = A.T @ A
    P[1 + np.arange(n), np.arange(n), np.arange(n)] = 1.0
    q = np.zeros((n + 1, n))
    q[0] = -2.0 * A.T @ b
    r = np.full(n + 1, -1.0)
    r[0] = b @ b
    return qt.make_form(P, q, r, np.ones(n, bool)).astype(jnp.float32)


@pytest.fixture
def gpu_backend(monkeypatch):
    monkeypatch.setattr(sdp.jax, "default_backend", lambda: "gpu")


def test_relaxation_device_policy(gpu_backend):
    assert sdp._relaxation_device("auto") is None
    assert sdp._relaxation_device("device") is None
    assert sdp._relaxation_device("host").platform == "cpu"
    dev = jax.devices()[1]
    assert sdp._relaxation_device(dev) is dev


def test_sdr_f32_attempt_stays_on_device(gpu_backend, monkeypatch):
    """An accepted f32 device attempt never touches the f64 re-solve."""
    def fail(*a, **k):
        raise AssertionError("the f32 attempt was re-solved in f64")

    monkeypatch.setattr(sdp, "_solve_f64", fail)
    X, bound = sdp.solve_sdr(_bls_form32())
    assert np.isfinite(float(bound))


def test_sdr_rejected_f32_resolves_f64_on_device(gpu_backend, monkeypatch):
    """A rejected f32 attempt is re-solved in float64 on the default
    device (dev=None), never on the host CPU."""
    devs = []
    real = sdp._solve_f64

    def spy(data_fn, form, max_iters, tol, dev, init, sk):
        devs.append(dev)
        return real(data_fn, form, max_iters, tol, dev, init, sk)

    monkeypatch.setattr(sdp, "_solve_f64", spy)
    monkeypatch.setattr(sdp, "_INACC_TOL", 0.0)      # reject every attempt
    X, bound = sdp.solve_sdr(_bls_form32(), check=False)
    assert devs == [None]
    assert np.isfinite(float(bound))


def test_sdr_host_is_explicit(gpu_backend, monkeypatch):
    devs = []
    real = sdp._solve_f64

    def spy(data_fn, form, max_iters, tol, dev, init, sk):
        devs.append(dev)
        return real(data_fn, form, max_iters, tol, dev, init, sk)

    monkeypatch.setattr(sdp, "_solve_f64", spy)
    sdp.solve_sdr(_bls_form32(), device="host")
    assert [d.platform for d in devs] == ["cpu"]
