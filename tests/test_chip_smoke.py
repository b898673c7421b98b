"""chip_smoke.py's phases at tiny sizes on the CPU (the sweep kernel in the
Pallas interpreter), and its refusal to run without a GPU."""

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

KERNEL = dict(use_fused=True, interpret=True)
# At a few dozen restarts the kernel-vs-XLA comparison is chaotic; tiny
# runs hold it to the per-instance margins of tests/test_cd_sweep_pallas.py,
# not to the bench-shape limits (the percoord limit holds at every size).
TINY_CD = dict(bls_restarts=32, bls_sweeps=20, med_vs_xla=2.5,
               feas_margin=0.08)


def _ok(phase):
    line = phase.line()
    failed = {k: v for k, v in line["checks"].items() if not v["ok"]}
    assert line["ok"], failed
    return line


@pytest.mark.parametrize("name,run", [
    ("sdr", lambda: cs.phase_sdr(n_big=12, max_iters=2000)),
    ("examples", cs.phase_examples),
    ("cd", lambda: cs.phase_cd(n=12, m=7, R=64, sweeps=3, **TINY_CD,
                               **KERNEL)),
    ("improve", lambda: cs.phase_improve(n=12, m=7, R_admm=32, R_b=16,
                                         use_fused=True)),
    ("four", lambda: cs.phase_four(jax.devices()[:4], n=12, m=7, R=64,
                                   sweeps=3, **KERNEL)),
])
def test_phase_at_tiny_size(name, run):
    line = _ok(run())
    assert line["phase"] == name


def test_cd_phase_routes_to_the_kernel_on_gpu(monkeypatch):
    """With the router seeing a GPU, the CD phase takes the sweep kernel
    without any override (interpreted here)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    line = _ok(cs.phase_cd(n=8, m=5, R=32, sweeps=2, interpret=True,
                           **TINY_CD))
    assert line["checks"]["bench_best_finite"]["path"] == "kernel"


def test_refuses_non_gpu_platform(capsys):
    assert jax.devices()[0].platform == "cpu"
    assert cs.main([]) != 0
    assert cs.main(["--four"]) != 0
    assert capsys.readouterr().out == ""


def test_refuses_without_the_repository(tmp_path):
    """Copied alone into an empty directory, the script fails and prints
    nothing on stdout."""
    import shutil
    import subprocess
    shutil.copy(cs.__file__, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""


def test_precheck_phase_on_the_gpu_route(monkeypatch):
    """The sub-second classification comes from the host Farkas pre-check,
    which runs ahead of the f32 device attempt (the GPU route)."""
    from qcqp_tpu.solvers import sdp
    monkeypatch.setattr(sdp.jax, "default_backend", lambda: "gpu")
    line = _ok(cs.phase_precheck())
    assert line["checks"]["infeasible_precheck"]["raised"]
