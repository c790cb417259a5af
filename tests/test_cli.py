"""CLI end-to-end in a subprocess (CPU, tiny frame)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from raytracer_tpu.utils.png import read_png_rgb8

pytestmark = pytest.mark.heavy  # subprocess renders recompile per process

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "-m", "raytracer_tpu", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )


def test_cli_whitted_only(tmp_path):
    out = str(tmp_path / "cli.png")
    r = _run(["--scene", "01-spheres", "--width", "12", "--height", "8",
              "--depth", "1", "--epochs", "0", "--out", out,
              "--tile-rays", "96"], cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    img = read_png_rgb8(out)
    assert img.shape == (8, 12, 3)
    assert img.sum() > 0
    assert "rays in" in r.stdout


def test_cli_epochs_and_checkpoint(tmp_path):
    out = str(tmp_path / "cli2.png")
    ckpt = str(tmp_path / "cli2.npz")
    r = _run(["--scene", "01-spheres", "--width", "12", "--height", "8",
              "--depth", "1", "--epochs", "2", "--out", out,
              "--checkpoint", ckpt, "--tile-rays", "96"], cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(ckpt)
    data = np.load(ckpt)
    assert int(data["epoch"]) == 2
    # resume prints the resume line and runs 1 more epoch
    r2 = _run(["--scene", "01-spheres", "--width", "12", "--height", "8",
               "--depth", "1", "--epochs", "3", "--out", out,
               "--checkpoint", ckpt, "--tile-rays", "96"], cwd=REPO)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed at epoch 2" in r2.stdout


def test_cli_retries_resumes_after_transient_failure(tmp_path):
    """--retries: the supervisor relaunches a render whose process dies
    mid-schedule (injected after the whitted pass checkpointed, like a
    device fault) and the retry resumes from the checkpoint and
    completes the schedule."""
    out = str(tmp_path / "sup.png")
    tok = str(tmp_path / "fail.token")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               RAYTPU_TEST_FAIL_TOKEN=tok, RAYTPU_RETRY_DELAY="0")
    r = subprocess.run(
        [sys.executable, "-m", "raytracer_tpu", "--scene", "01-spheres",
         "--width", "12", "--height", "8", "--depth", "1", "--epochs", "2",
         "--out", out, "--tile-rays", "96", "--retries", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    assert os.path.exists(tok)  # the injected failure actually fired
    assert "supervisor: attempt 1 failed" in r.stdout
    assert "resumed at epoch 0" in r.stdout
    # the auto-derived checkpoint is cleaned up on success, so rerunning
    # the same command renders afresh instead of resuming at epoch==epochs
    assert not os.path.exists(out + ".ckpt.npz")
    img = read_png_rgb8(out)
    assert img.shape == (8, 12, 3) and img.sum() > 0


def test_cli_retries_aborts_on_deterministic_failure(tmp_path):
    """--retries loop prevention (cli.py _supervise): a child that fails
    the same way every launch with zero checkpoint progress must be
    declared deterministic after TWO no-progress failures and abort —
    not burn all N relaunches (each costing a 30 s default delay)."""
    out = str(tmp_path / "det.png")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               RAYTPU_TEST_FAIL_ALWAYS="1", RAYTPU_RETRY_DELAY="0")
    r = subprocess.run(
        [sys.executable, "-m", "raytracer_tpu", "--scene", "01-spheres",
         "--width", "12", "--height", "8", "--depth", "1", "--epochs", "2",
         "--out", out, "--tile-rays", "96", "--retries", "5"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode != 0, r.stdout[-2000:]
    assert "deterministic error, giving up" in r.stdout
    # aborted after exactly 2 attempts, not the 6 the budget allowed
    assert "supervisor: attempt 1 failed" in r.stdout
    assert "supervisor: attempt 2 failed" not in r.stdout


def test_cli_warm_cache(tmp_path):
    """--warm-cache compiles the config's programs and exits without
    touching the output path."""
    out = str(tmp_path / "never.png")
    r = _run(["--scene", "01-spheres", "--width", "12", "--height", "8",
              "--depth", "1", "--epochs", "5", "--out", out,
              "--tile-rays", "96", "--warm-cache"], cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "warm-cache: programs compiled+cached" in r.stdout
    assert not os.path.exists(out)


def test_cli_supervisor_opens_no_device(tmp_path):
    """The --retries parent spawns the render child without initialising
    any JAX backend itself, so only the child holds the card."""
    code = (
        "import subprocess, sys\n"
        "from jax._src import xla_bridge\n"
        "from raytracer_tpu import cli\n"
        "subprocess.call = lambda *a, **k: 0\n"
        f"rc = cli.main(['--epochs', '1', '--out', {str(tmp_path / 'x.png')!r},"
        " '--retries', '1'])\n"
        "print('rc', rc, 'backends', xla_bridge.backends_are_initialized())\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "rc 0 backends False" in r.stdout, r.stdout
