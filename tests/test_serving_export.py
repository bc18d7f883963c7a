"""AOT serving artifacts: export + load roundtrips must reproduce the
live programs bit-for-bit (jax.export records the same StableHLO the
live jit lowers to — any drift means the artifact is not the program).
"""

import dataclasses

import numpy as np
import pytest

from kompass_core_tpu.ops.solver import (
    SolverSpec,
    get_packed_dwa_solver,
    pack_solver_input,
    packed_input_size,
    unpack_solver_output,
)
from kompass_core_tpu.ops.window import sample_velocity_window
from kompass_core_tpu.serving import (
    export_fleet_tick,
    export_packed_solver,
    load_artifact,
    load_packed_solver,
    read_artifact_header,
)

SPEC = SolverSpec(
    is_omni=False, n_vx=5, n_vy=1, n_omega=5, max_points=10,
    num_ctrl_points=2, scan_size=32, seg_size=64,
)


def _packed_buffer(spec):
    limits = np.zeros(9, np.float32)
    limits[0:3] = (1.0, 5.0, 10.0)
    limits[6:9] = (2.0, 3.0, 3.0)
    vel = (0.42, 0.0, -0.13)
    window = sample_velocity_window(vel, limits, 0.1, 5, 1, 5, False)
    n_seg = 40
    seg_x = np.full(64, 1e8, np.float32)
    seg_x[:n_seg] = np.linspace(0, 3.9, n_seg)
    seg_y = np.full(64, 1e8, np.float32)
    seg_y[:n_seg] = 0.0
    seg_arc = np.zeros(64, np.float32)
    seg_arc[:n_seg] = np.linspace(0, 3.9, n_seg)
    obs = np.full((spec.scan_size, 2), 1e8, np.float32)
    obs[0] = [1.5, 0.3]
    params = np.array(
        [0.1, 0.2, 0.05, 2.0, 1.0, 1.0, 0.0, 0.0, 5.0, 0.0, 3.0, 10 / 3],
        np.float32,
    )
    buf = np.zeros(packed_input_size(spec), np.float32)
    pack_solver_input(
        spec, buf, params_vec=params, state=(0.0, 0.0, 0.1), window=window,
        obs_xy=obs, obs_count=1, seg_x=seg_x, seg_y=seg_y, seg_arc=seg_arc,
        seg_count=n_seg, seg_total_len=3.9, ref_total_len=3.9,
        active_points=10,
    )
    return buf


def test_packed_solver_artifact_roundtrip(tmp_path):
    path = str(tmp_path / "solver.ktpuart")
    header = export_packed_solver(SPEC, path)
    assert header["kind"] == "packed_dwa_solver"

    buf = _packed_buffer(SPEC)
    live = np.asarray(get_packed_dwa_solver(SPEC)(buf))

    art, spec_loaded = load_packed_solver(path)
    assert spec_loaded == SPEC  # full static geometry survives the header
    served = np.asarray(art.call(buf))
    np.testing.assert_array_equal(live, served)

    # the decoded result is a real solve
    out = unpack_solver_output(spec_loaded, served)
    assert out[0] == 1.0  # found


def test_artifact_header_is_cheap_and_versioned(tmp_path):
    path = str(tmp_path / "solver.ktpuart")
    export_packed_solver(SPEC, path)
    header = read_artifact_header(path)  # no jax deserialization
    import jax

    assert header["jax_version"] == jax.__version__
    assert header["platforms"]  # lowering platforms recorded
    assert header["meta"]["solver_spec"]["scan_size"] == 32


def test_multi_platform_artifact_runs_on_cpu(tmp_path):
    """One artifact lowered for BOTH cpu and cuda (the deployment shape:
    build once on a CPU box, serve on either) must execute on the CPU
    backend and agree bit-for-bit with the live program."""
    path = str(tmp_path / "multi.ktpuart")
    header = export_packed_solver(SPEC, path, platforms=("cpu", "cuda"))
    assert header["platforms"] == ["cpu", "cuda"]
    buf = _packed_buffer(SPEC)
    live = np.asarray(get_packed_dwa_solver(SPEC)(buf))
    art, _ = load_packed_solver(path)
    np.testing.assert_array_equal(live, np.asarray(art.call(buf)))


def test_load_packed_solver_rejects_other_kinds(tmp_path):
    from kompass_core_tpu.serving import export_callable

    path = str(tmp_path / "other.ktpuart")
    export_callable(lambda x: x * 2, (np.float32(1.0),), path, kind="misc")
    with pytest.raises(ValueError, match="kind"):
        load_packed_solver(path)


def test_not_an_artifact(tmp_path):
    p = tmp_path / "junk.bin"
    p.write_bytes(b"definitely not an artifact")
    with pytest.raises(ValueError, match="not a kompass_core_tpu artifact"):
        read_artifact_header(str(p))


def test_box_spec_roundtrips(tmp_path):
    spec = dataclasses.replace(SPEC, collision_box=(0.5, 0.2))
    path = str(tmp_path / "box.ktpuart")
    export_packed_solver(spec, path)
    _, spec_loaded = load_packed_solver(path)
    assert spec_loaded == spec
    assert isinstance(spec_loaded.collision_box, tuple)


N_RAYS = 72
N_ROBOTS = 3


def _make_fleet(n=None):
    from kompass_core_tpu.control import DWAConfig, TrajectoryCostsWeights
    from kompass_core_tpu.models import (
        AngularCtrlLimits, LinearCtrlLimits, Robot, RobotCtrlLimits,
        RobotGeometry, RobotType,
    )
    from kompass_core_tpu.parallel.fleet_v2 import DeviceFleet

    robots = [
        Robot(
            robot_type=RobotType.DIFFERENTIAL_DRIVE,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([0.1, 0.4]),
        )
        for _ in range(n or N_ROBOTS)
    ]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(
            max_vel=4.0, max_acc=3.0, max_decel=3.0, max_steer=np.pi
        ),
    )
    config = DWAConfig(
        max_linear_samples=4, max_angular_samples=4,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=3.0, goal_distance_weight=1.0,
            smoothness_weight=0.0, jerk_weight=0.0,
            obstacles_distance_weight=0.0,
        ),
        prediction_horizon=10, control_horizon=2, control_time_step=0.1,
    )
    return DeviceFleet(
        robots, limits, config, scan_rays=N_RAYS, path_capacity=512,
        max_segments=16,
    )


def _prime_fleet(fleet):
    n = fleet.num_robots
    fleet.set_paths([
        np.array([[0.0, float(i)], [3.0, float(i)]])
        for i in range(n)
    ])
    fleet.set_scan_angles(np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False))
    # one packed input matrix: states | vels | ranges
    states = np.zeros((n, 4), np.float32)
    states[:, 1] = np.arange(n)
    fleet._inputs[:n, :4] = states
    fleet._inputs[:n, 4:7] = 0.0
    fleet._inputs[:n, 7:] = 10.0


def test_fleet_tick_artifact_matches_live_program(tmp_path):
    fleet = _make_fleet()
    _prime_fleet(fleet)
    n_robots = N_ROBOTS

    path = str(tmp_path / "fleet.ktpuart")
    header = export_fleet_tick(fleet, path)
    assert header["meta"]["n_robots"] == fleet._n

    args = fleet.tick_example_args()
    live_carry, live_out = fleet._tick_fn(*args)
    art = load_artifact(path)
    srv_carry, srv_out = art.call(*args)

    np.testing.assert_array_equal(np.asarray(live_out), np.asarray(srv_out))
    for a, b in zip(
        jax_tree_leaves(live_carry), jax_tree_leaves(srv_carry)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def jax_tree_leaves(tree):
    import jax

    return jax.tree_util.tree_leaves(tree)


def test_tracked_fleet_artifact_roundtrip(tmp_path):
    """A moving-obstacle fleet's artifact must record the widened input
    layout (meta.tracked_obstacles) and reproduce the live program."""
    from kompass_core_tpu.control import DWAConfig, TrajectoryCostsWeights
    from kompass_core_tpu.models import (
        AngularCtrlLimits, LinearCtrlLimits, Robot, RobotCtrlLimits,
        RobotGeometry, RobotType,
    )
    from kompass_core_tpu.parallel.fleet_v2 import DeviceFleet

    robots = [
        Robot(
            robot_type=RobotType.DIFFERENTIAL_DRIVE,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([0.1, 0.4]),
        )
        for _ in range(2)
    ]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(
            max_vel=4.0, max_acc=3.0, max_decel=3.0, max_steer=np.pi
        ),
    )
    config = DWAConfig(
        max_linear_samples=4, max_angular_samples=4,
        prediction_horizon=8, control_horizon=2, control_time_step=0.1,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=3.0, goal_distance_weight=1.0,
            obstacles_distance_weight=0.5,
        ),
    )
    fleet = DeviceFleet(
        robots, limits, config, scan_rays=N_RAYS, path_capacity=512,
        max_segments=16, tracked_obstacles=2,
    )
    fleet.set_paths([np.array([[0.0, float(i)], [3.0, float(i)]])
                     for i in range(2)])
    fleet.set_scan_angles(np.linspace(0, 2 * np.pi, N_RAYS,
                                      endpoint=False))
    fleet._inputs[:2, 7 : 7 + N_RAYS] = 10.0
    fleet._write_tracked([np.array([[0.8, 0.0, 0.0, -0.5]], np.float32),
                          np.zeros((0, 4), np.float32)])

    path = str(tmp_path / "fleet_tracked.ktpuart")
    header = export_fleet_tick(fleet, path)
    assert header["meta"]["tracked_obstacles"] == 2
    # header-only sizing must reconstruct the input width
    m = header["meta"]
    width = 4 + 3 + m["scan_rays"] + 4 * m["tracked_obstacles"]
    assert fleet._inputs.shape[1] == width

    args = fleet.tick_example_args()
    live_carry, live_out = fleet._tick_fn(*args)
    art = load_artifact(path)
    srv_carry, srv_out = art.call(*args)
    np.testing.assert_array_equal(np.asarray(live_out), np.asarray(srv_out))


def test_fleet_ticks_on_device_artifact_matches_live(tmp_path):
    from kompass_core_tpu.ops.fleet_solver import make_fleet_ticks_on_device
    from kompass_core_tpu.serving import export_fleet_ticks_on_device

    k = 4
    fleet = _make_fleet()
    _prime_fleet(fleet)
    path = str(tmp_path / "fleet_k.ktpuart")
    header = export_fleet_ticks_on_device(fleet, k, path)
    assert header["meta"]["k_ticks"] == k

    args = fleet.tick_example_args()
    live_fn = make_fleet_ticks_on_device(
        fleet.spec, k, chunk=fleet._chunk or None
    )
    live_carry, live_out, live_fin = live_fn(*args)
    art = load_artifact(path)
    srv_carry, srv_out, srv_fin = art.call(*args)
    np.testing.assert_array_equal(np.asarray(live_out), np.asarray(srv_out))
    np.testing.assert_array_equal(np.asarray(live_fin), np.asarray(srv_fin))
    for a, b in zip(jax_tree_leaves(live_carry), jax_tree_leaves(srv_carry)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _tick_inputs(step):
    states = np.zeros((N_ROBOTS, 4), np.float32)
    states[:, 0] = 0.05 * step
    states[:, 1] = np.arange(N_ROBOTS)
    vels = np.full((N_ROBOTS, 3), 0.1, np.float32)
    ranges = np.full((N_ROBOTS, N_RAYS), 10.0 - 0.01 * step, np.float32)
    angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
    return states, vels, ranges, angles


def test_artifact_cold_load_in_fresh_process(tmp_path):
    """The serving claim, executed literally: a FRESH process that
    imports only ``kompass_core_tpu.serving`` (never the solver /
    tracing modules) loads the artifact and reproduces this process's
    solve bit-for-bit."""
    import json
    import os
    import subprocess
    import sys

    art_path = str(tmp_path / "solver.ktpuart")
    export_packed_solver(SPEC, art_path)
    buf = _packed_buffer(SPEC)
    live = np.asarray(get_packed_dwa_solver(SPEC)(buf))
    buf_path = str(tmp_path / "buf.npy")
    out_path = str(tmp_path / "out.npy")
    np.save(buf_path, buf)

    code = f"""
import sys
import numpy as np
import kompass_core_tpu.serving as serving
banned = [m for m in sys.modules
          if m.startswith("kompass_core_tpu.ops")
          or m.startswith("kompass_core_tpu.control")]
assert not banned, f"serving import pulled in tracing modules: {{banned}}"
art = serving.load_artifact({art_path!r})
out = np.asarray(art.call(np.load({buf_path!r})))
np.save({out_path!r}, out)
print("cold-load ok")
"""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms', 'cpu');" + code],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert "cold-load ok" in r.stdout
    np.testing.assert_array_equal(live, np.load(out_path))


def test_fleet_snapshot_resume_bit_exact(tmp_path):
    """A fresh process restores a mid-mission snapshot and continues
    bit-for-bit — the serving-restart contract (state_dict pairs with
    the AOT artifact so neither tracing nor path re-interpolation runs
    at restart)."""
    fleet_a = _make_fleet()
    _prime_fleet(fleet_a)
    for step in range(4):
        fleet_a.tick(*_tick_inputs(step))

    sd = fleet_a.state_dict()
    # must survive a disk roundtrip
    f = tmp_path / "fleet_state.npz"
    np.savez(f, **sd)
    sd2 = dict(np.load(str(f)))

    after_a = [fleet_a.tick(*_tick_inputs(4 + s)) for s in range(3)]

    fleet_b = _make_fleet()
    fleet_b.load_state_dict(sd2)
    after_b = [fleet_b.tick(*_tick_inputs(4 + s)) for s in range(3)]

    for out_a, out_b in zip(after_a, after_b):
        for key in out_a:
            np.testing.assert_array_equal(out_a[key], out_b[key])


def test_load_state_dict_rejects_mismatched_fleet():
    fleet = _make_fleet()
    _prime_fleet(fleet)
    sd = fleet.state_dict()
    sd["scan_rays"] = np.int32(128)
    fleet2 = _make_fleet()
    with pytest.raises(ValueError, match="shape mismatch"):
        fleet2.load_state_dict(sd)


def test_state_dict_before_set_paths_raises():
    fleet = _make_fleet()
    with pytest.raises(RuntimeError, match="set_paths"):
        fleet.state_dict()


def test_artifact_shards_at_serving_site(tmp_path):
    """The shard-at-serving-site contract, executed: a
    FRESH process loads the single-device fleet-tick artifact and serves
    a 4x-larger fleet across 4 virtual devices via
    ``serving.sharded_fleet_call`` — outputs bit-identical to the
    monolithic live fleet, with each shard committed to its own
    device."""
    import os
    import subprocess
    import sys

    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 virtual devices")
    n_shard, n_dev = N_ROBOTS, 4

    # export the per-shard program from a small fleet
    shard_fleet = _make_fleet(n_shard)
    _prime_fleet(shard_fleet)
    art_path = str(tmp_path / "shard_fleet.ktpuart")
    from kompass_core_tpu.serving import export_fleet_tick

    export_fleet_tick(shard_fleet, art_path)

    # the full fleet: same construction, 4x the robots; its tick is the
    # ground truth the sharded serving must reproduce exactly
    full = _make_fleet(n_shard * n_dev)
    _prime_fleet(full)
    args = full.tick_example_args()
    live_carry, live_out = full._tick_fn(*args)

    # dump the argument tree for the serving process
    arg_dir = str(tmp_path / "args.npz")
    flat, _ = jax.tree_util.tree_flatten(args)
    np.savez(arg_dir, **{f"a{i}": np.asarray(x) for i, x in enumerate(flat)})
    out_path = str(tmp_path / "served.npz")

    # fresh process: loads ONLY serving + the artifact, rebuilds the arg
    # tree, shards across its 4 devices
    code = f"""
import numpy as np, sys
import jax
import kompass_core_tpu.serving as serving
banned = [m for m in sys.modules if m.startswith("kompass_core_tpu.ops")]
assert not banned, banned
art = serving.load_artifact({art_path!r})
z = np.load({arg_dir!r})
flat = [z[f"a{{i}}"] for i in range(len(z.files))]
from kompass_core_tpu.ops.fleet_solver import FleetCarry, FleetConfig, FleetPaths
paths = FleetPaths(*flat[0:8])
cfg = FleetConfig(*flat[8:21])
carry = FleetCarry(*flat[21:26])
angles, inputs = flat[26], flat[27]
devs = jax.devices()[:4]
carry2, out = serving.sharded_fleet_call(
    art, (paths, cfg, carry, angles, inputs), devs)
np.savez({out_path!r}, out=out, **{{f"c{{i}}": c for i, c in enumerate(carry2)}})
print("sharded serving ok")
"""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms', 'cpu');" + code],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr
    assert "sharded serving ok" in r.stdout

    served = np.load(out_path)
    np.testing.assert_array_equal(np.asarray(live_out), served["out"])
    for i, c in enumerate(live_carry):
        np.testing.assert_array_equal(np.asarray(c), served[f"c{i}"])


def test_sharded_fleet_call_in_process_places_shards():
    """In-process check of the row math: 2 devices, outputs bit-equal to
    the monolithic fleet; a wrong device count raises."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs >= 2 devices")
    import os
    import tempfile

    from kompass_core_tpu.serving import (
        export_fleet_tick,
        load_artifact,
        sharded_fleet_call,
    )

    shard_fleet = _make_fleet(N_ROBOTS)
    _prime_fleet(shard_fleet)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "f.ktpuart")
        export_fleet_tick(shard_fleet, p)
        art = load_artifact(p)
        full = _make_fleet(N_ROBOTS * 2)
        _prime_fleet(full)
        args = full.tick_example_args()
        live_carry, live_out = full._tick_fn(*args)
        devs = jax.devices()[:2]
        carry2, out = sharded_fleet_call(art, args, devs)
        np.testing.assert_array_equal(np.asarray(live_out), out)
        for a, b in zip(live_carry, carry2):
            np.testing.assert_array_equal(np.asarray(a), b)
        # serving-loop form: shard ONCE, reuse across calls — the static
        # tables never re-upload
        from kompass_core_tpu.serving import shard_fleet_args

        shards = shard_fleet_args(art, args, devs)
        carry3, out3 = sharded_fleet_call(art, args, devs, shards=shards)
        np.testing.assert_array_equal(out3, out)
        for a, b in zip(carry2, carry3):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="fleet rows"):
        sharded_fleet_call(art, args, jax.devices()[:1])


def test_sharded_fleet_call_refuses_peer_artifacts(tmp_path):
    """Peer-avoidance rows interact — row-chunked serving would give
    shard-local-only avoidance with no error. The artifact records the
    flag and sharded serving must refuse it."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs >= 2 devices")
    from kompass_core_tpu.control import DWAConfig, TrajectoryCostsWeights
    from kompass_core_tpu.models import (
        AngularCtrlLimits, LinearCtrlLimits, Robot, RobotCtrlLimits,
        RobotGeometry, RobotType,
    )
    from kompass_core_tpu.parallel.fleet_v2 import DeviceFleet
    from kompass_core_tpu.serving import sharded_fleet_call

    robots = [
        Robot(
            robot_type=RobotType.DIFFERENTIAL_DRIVE,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([0.1, 0.4]),
        )
        for _ in range(2)
    ]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0,
                                   max_decel=10.0),
        omega_limits=AngularCtrlLimits(
            max_vel=4.0, max_acc=3.0, max_decel=3.0, max_steer=np.pi
        ),
    )
    config = DWAConfig(
        max_linear_samples=4, max_angular_samples=4,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=3.0, goal_distance_weight=1.0,
        ),
        prediction_horizon=10, control_horizon=2, control_time_step=0.1,
    )
    fleet = DeviceFleet(
        robots, limits, config, scan_rays=N_RAYS, path_capacity=256,
        max_segments=8, peer_avoidance=True,
    )
    fleet.set_paths([
        np.array([[0.0, float(i)], [3.0, float(i)]]) for i in range(2)
    ])
    fleet.set_scan_angles(np.linspace(0, 2 * np.pi, N_RAYS,
                                      endpoint=False))
    path = str(tmp_path / "peer_fleet.ktpuart")
    header = export_fleet_tick(fleet, path)
    assert header["meta"]["peer_avoidance"] is True
    art = load_artifact(path)
    with pytest.raises(ValueError, match="peer-avoidance"):
        sharded_fleet_call(
            art, fleet.tick_example_args(), jax.devices()[:2]
        )


def test_sharded_fleet_call_refuses_artifacts_without_peer_marker():
    """Artifacts exported before the ``peer_avoidance`` header field
    existed must be REFUSED, not silently treated as peer-free — a
    pre-marker peer artifact would otherwise get exactly the
    shard-local-only avoidance the guard exists to prevent (round-5
    review)."""
    import jax

    from kompass_core_tpu.serving import sharded_fleet_call
    from kompass_core_tpu.serving.export import LoadedArtifact

    art = LoadedArtifact(
        header={"kind": "fleet_tick", "meta": {"n_robots": 1}},
        call=lambda *a: a,
    )
    with pytest.raises(ValueError, match="older build"):
        sharded_fleet_call(art, (), jax.devices()[:1])
