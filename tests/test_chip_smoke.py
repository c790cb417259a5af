"""chip_smoke.py where the CPU can reach it: the refusal to run without a
GPU, the compile-cache rule, the tolerance helper, the phase plan, the
last line, and its phases rehearsed at tiny sizes on the CPU backend."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    import chip_smoke  # the repo root is on sys.path (tests is a package)

    return chip_smoke


def _run(args, cwd, **env):
    e = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=e,
                          capture_output=True, text=True, timeout=300)


def _last_line(stdout):
    lines = [ln for ln in stdout.splitlines() if ln.strip()]
    return lines[-1] if lines else ""


@pytest.mark.parametrize("args", [[], ["--multi"]], ids=["one", "multi"])
def test_exits_nonzero_without_gpu(args):
    r = _run([os.path.join(REPO, "chip_smoke.py"), *args], cwd=REPO)
    assert r.returncode != 0
    assert '"ok": true' not in _last_line(r.stdout)
    assert "need" in r.stderr and "GPU" in r.stderr


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("env_set", [False, True], ids=["unset", "set"])
def test_compile_cache_rule(tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins and the program sets no directory of
    its own; unset, the cache is the fixed <repo>/.jax_cache."""
    code = (
        "import jax\n"
        "from raytracer_tpu.utils import cache\n"
        "cache.enable_compile_cache()\n"
        "print(repr(jax.config.jax_compilation_cache_dir), "
        "repr(cache.cache_dir()))\n"
    )
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if env_set else {}
    e = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    if not env_set:
        e.pop("JAX_COMPILATION_CACHE_DIR", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=e,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    configured, reported = [eval(x) for x in r.stdout.split()]
    if env_set:
        assert configured == reported == str(tmp_path)  # JAX read the var
    else:
        want = os.path.join(REPO, ".jax_cache")
        assert configured == reported == want


def test_compare_identical_images():
    m = _smoke()
    img = np.random.default_rng(0).random((48, 64, 3)).astype(np.float32)
    res = m.compare(img, img.copy(), m.TOL_CPU)
    assert res["ok"] and res["bad_frac"] == 0.0 and res["max_abs"] == 0.0


@pytest.mark.parametrize("n_bad,ok", [(10, True), (40, False)],
                         ids=["flips-within-cap", "flips-past-cap"])
def test_compare_perturbed_images(n_bad, ok):
    """Isolated flips pass up to the cap; agreeing pixels may drift below
    atol; more flipped pixels than the cap fail."""
    m = _smoke()
    rng = np.random.default_rng(1)
    want = rng.random((48, 64, 3)).astype(np.float32)
    got = want + rng.uniform(-5e-4, 5e-4, want.shape).astype(np.float32)
    flat = got.reshape(-1, 3)
    flat[rng.choice(flat.shape[0], n_bad, replace=False)] += 0.5
    res = m.compare(got, want, m.TOL_CPU)  # cap 0.5% of 3072 = 15 pixels
    assert res["ok"] is ok
    assert res["max_abs_agreeing"] <= m.TOL_CPU.atol
    assert res["bad_frac"] == pytest.approx(n_bad / 3072)


def test_compare_rejects_nan_and_shape():
    m = _smoke()
    want = np.ones((4, 4, 3), np.float32)
    got = want.copy()
    got[0, 0, 0] = np.nan
    assert not m.compare(got, want, m.TOL_MC)["finite"]
    assert not m.compare(want[:2], want, m.TOL_MC)["ok"]


@pytest.mark.parametrize("multi", [False, True], ids=["one", "multi"])
def test_phase_plan(multi):
    m = _smoke()
    plan = m.phases(multi)
    assert plan[0] == "device"
    if multi:
        assert plan == ["device", "multi"]  # only the four-card path
    else:
        assert "multi" not in plan
        assert set(plan) == {"device", "main", "full", "goldens", "gpu_tests"}


def test_result_line():
    m = _smoke()
    line = m.result_line({"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                          "count": 1, "extra": 5})
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')


def test_rehearse_goldens_on_cpu(capsys):
    """Phase (b) on the CPU: the committed CPU goldens come back exactly."""
    m = _smoke()
    rep = m.Report("cpu rehearsal")
    m.phase_goldens(rep, [g for g in m.GOLDENS
                          if g[2] in ("whitted_demo_64x48.npy",
                                      "mc_demo_64x48.npy")])
    out = capsys.readouterr().out
    assert rep.failed == [], out
    assert '"bad_frac": 0.0' in out and "[card: cpu rehearsal]" in out


def test_rehearse_full_width_on_cpu(capsys):
    m = _smoke()
    rep = m.Report("cpu rehearsal")
    m.phase_full(rep, width=64, height=48, band=(20, 24))
    out = capsys.readouterr().out
    assert rep.failed == [], out
    assert "band linear GPU vs CPU: OK" in out


def test_rehearse_main_path_on_cpu(capsys):
    """Phase (d) at a tiny size: both CLI schedules write the same PNG."""
    m = _smoke()
    rep = m.Report("cpu rehearsal")
    m.phase_main(rep, width=32, height=16, epochs=2, mesh_size=16,
                 mesh_grid=4, reps=1)
    out = capsys.readouterr().out
    assert rep.failed == [], out
    assert '"byte_identical": true' in out
    assert "cli per-epoch: " in out and "rays in" in out
    assert out.count("step ") == 5


def test_rehearse_multi_on_cpu(capsys):
    """The four-card phase on four virtual CPU devices."""
    m = _smoke()
    rep = m.Report("cpu rehearsal")
    m.phase_multi(rep, width=32, height=16, n_dev=4)
    out = capsys.readouterr().out
    assert rep.failed == [], out
    assert "dp=4 vs one card: OK" in out
    assert "train_steps_sharded group k=2" in out
