"""What ties the program to the machine it runs on: the compile cache,
the card's identity and peak rates, multi-process start-up, the
multi-platform serving artifact, and the GPU smoke script's refusal to
run anywhere but on a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, env_extra=None, cwd=ROOT, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["PYTHONPATH"] = ROOT
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=cwd, capture_output=True,
        text=True, timeout=240,
    )


def test_compile_cache_uses_jax_compilation_cache_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, compiled programs land there
    and the checkout's own cache directory is not configured."""
    code = (
        "import jax, jax.numpy as jnp, os\n"
        "from kompass_core_tpu.utils import runtime\n"
        "runtime.enable_persistent_compilation_cache()\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda x: jnp.sin(x) * 3.0)(jnp.ones(4)).block_until_ready()\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    cache = tmp_path / "cache"
    r = _run(code, {"JAX_COMPILATION_CACHE_DIR": str(cache)})
    assert r.returncode == 0, r.stderr[-800:]
    assert r.stdout.strip().splitlines()[-1] == str(cache)
    assert any(cache.iterdir()), "no compiled program was cached"


def test_compile_cache_defaults_to_checkout_dir():
    code = (
        "import jax\n"
        "from kompass_core_tpu.utils import runtime\n"
        "runtime.enable_persistent_compilation_cache()\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    r = _run(code, drop=("JAX_COMPILATION_CACHE_DIR",
                         "KOMPASS_TPU_NO_CACHE"))
    assert r.returncode == 0, r.stderr[-800:]
    got = r.stdout.strip().splitlines()[-1]
    assert got == os.path.join(ROOT, ".jax_cache")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_a_gpu(tmp_path, alone):
    """Under JAX_PLATFORMS=cpu (and, in a directory with nothing else of
    the repo) chip_smoke.py exits non-zero and prints no ok line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, script], env=env, cwd=cwd,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("text,rows", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [{"name": "NVIDIA H100 80GB HBM3", "power.limit": "700.00 W"}]),
    ("NVIDIA H100 80GB HBM3, 400.00 W\n\nNVIDIA H100 80GB HBM3, 400.00 W\n",
     [{"name": "NVIDIA H100 80GB HBM3", "power.limit": "400.00 W"}] * 2),
    ("", []),
])
def test_parse_gpu_query(text, rows):
    from kompass_core_tpu.benchmark.device import parse_gpu_query

    assert parse_gpu_query(text) == rows


def test_parse_gpu_query_rejects_a_short_row():
    from kompass_core_tpu.benchmark.device import parse_gpu_query

    with pytest.raises(ValueError, match="fields"):
        parse_gpu_query("NVIDIA H100 80GB HBM3\n")


def test_peak_table_raises_on_an_unknown_kind():
    from kompass_core_tpu.benchmark.device import peaks_for

    with pytest.raises(KeyError, match="no peak rates"):
        peaks_for("cpu")


def test_peak_table_holds_the_h100_data_sheet():
    from kompass_core_tpu.benchmark.device import peaks_for

    p = peaks_for("NVIDIA H100 80GB HBM3")
    assert p["bf16_flops"] == 989e12 and p["f32_flops"] == 67e12
    assert p["hbm_bytes"] == 3.35e12


def test_initialize_multihost_passes_local_device_ids(monkeypatch):
    import jax

    from kompass_core_tpu.parallel import initialize_multihost

    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    initialize_multihost("localhost:12345", 4, 2, local_device_ids=[2])
    assert seen == {
        "coordinator_address": "localhost:12345", "num_processes": 4,
        "process_id": 2, "local_device_ids": [2],
    }
    seen.clear()
    initialize_multihost("localhost:12345", 1, 0)  # one process: no-op
    assert seen == {}


def test_dryrun_multichip_raises_with_too_few_devices():
    import jax

    from __graft_entry__ import dryrun_multichip

    with pytest.raises(RuntimeError, match="needs"):
        dryrun_multichip(len(jax.devices()) + 1)


def test_fleet_tick_artifact_lowers_for_cpu_and_cuda(tmp_path):
    """One fleet-tick artifact for both platforms, built on a CPU-only
    machine, runs on the CPU bit-equal to the live program."""
    from kompass_core_tpu.control import DWAConfig
    from kompass_core_tpu.models import (
        AngularCtrlLimits, LinearCtrlLimits, Robot, RobotCtrlLimits,
        RobotGeometry, RobotType,
    )
    from kompass_core_tpu.parallel.fleet_v2 import DeviceFleet
    from kompass_core_tpu.serving import export_fleet_tick, load_artifact

    robot = Robot(robot_type=RobotType.DIFFERENTIAL_DRIVE,
                  geometry_type=RobotGeometry.Type.CYLINDER,
                  geometry_params=np.array([0.2, 0.4]))
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=2.0, max_acc=3.0,
                                       max_decel=3.0),
    )
    fleet = DeviceFleet(
        [robot] * 2, limits,
        DWAConfig(max_linear_samples=4, max_angular_samples=4,
                  prediction_horizon=8, control_horizon=2),
        scan_rays=16, path_capacity=128, max_segments=4,
    )
    fleet.set_paths([np.array([[0.0, 0.0], [1.0, 0.0]])] * 2)
    fleet.set_scan_angles(np.linspace(-np.pi, np.pi, 16, endpoint=False))
    fleet._inputs[:, 7:] = 5.0
    path = str(tmp_path / "fleet.ktpuart")
    header = export_fleet_tick(fleet, path, platforms=("cpu", "cuda"))
    assert header["platforms"] == ["cpu", "cuda"]
    args = fleet.tick_example_args()
    _, live = fleet._tick_fn(*args)
    _, served = load_artifact(path).call(*args)
    np.testing.assert_array_equal(np.asarray(live), np.asarray(served))
