"""Fleet demo: N robots controlled by one sharded device dispatch per tick.

Spawns a row of robots, each with its own straight path, and drives them
all with the device-resident `DeviceFleet` (whole follower pipeline on
device; pass --host to use the host-follower `FleetRuntime` instead).

Pass --peers for the fleet-mutual-avoidance showcase: robots run in
CROSSING pairs (X-shaped paths that intersect at the center) with
`peer_avoidance=True` — each robot sees the others as live obstacle
discs on device, and the demo verifies no two robots ever get closer
than the contact distance.

Pass --mesh (with --peers/--predict) to run the same scenario with the
robot axis sharded over an 8-device virtual CPU mesh: the peer state
crosses devices as ONE bounded all_gather per tick (the steady state's
only collective, pinned by tests/test_scaling_hlo.py), and the
commands are bit-identical to the single-device program.

Run: PYTHONPATH=. python examples/fleet_demo.py [num_robots] [--host|--peers|--predict|--mesh]
"""

import sys
import time

import numpy as np

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))

if "--mesh" in _sys.argv:
    # the mesh demo runs on 8 virtual CPU devices, which must be
    # configured BEFORE the first jax backend initialization
    _flags = _os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        _os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    _os.environ["JAX_PLATFORMS"] = "cpu"
    import jax as _jax

    _jax.config.update("jax_platforms", "cpu")

from kompass_core_tpu.control import DWAConfig, TrajectoryCostsWeights
from kompass_core_tpu.datatypes import LaserScanData
from kompass_core_tpu.models import (
    AngularCtrlLimits,
    LinearCtrlLimits,
    Robot,
    RobotCtrlLimits,
    RobotGeometry,
    RobotType,
)
from kompass_core_tpu.parallel import FleetRuntime, build_fleet_mesh
from kompass_core_tpu.utils.runtime import (
    enable_persistent_compilation_cache,
)

enable_persistent_compilation_cache()


def main(n_robots: int = 100, host_mode: bool = False, peers: bool = False,
         predict: bool = False, mesh: bool = False):
    if peers or predict or mesh:
        return main_peers(n_robots, predict=predict, use_mesh=mesh)
    robots = [
        Robot(
            robot_type=RobotType.ACKERMANN,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([0.1, 0.4]),
        )
        for _ in range(n_robots)
    ]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(
            max_vel=4.0, max_acc=3.0, max_decel=3.0, max_steer=np.pi
        ),
    )
    config = DWAConfig(
        max_linear_samples=8,
        max_angular_samples=8,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=3.0,
            goal_distance_weight=1.0,
            smoothness_weight=0.0,
            jerk_weight=0.0,
            obstacles_distance_weight=0.0,
        ),
        prediction_horizon=10,
        control_horizon=2,
        control_time_step=0.1,
    )
    n_rays = 72
    angles = np.linspace(0, 2 * np.pi, n_rays, endpoint=False)
    if host_mode:
        fleet = FleetRuntime(robots, limits, config, mesh=build_fleet_mesh())
    else:
        from kompass_core_tpu.parallel import DeviceFleet

        fleet = DeviceFleet(
            robots, limits, config, scan_rays=n_rays, path_capacity=512,
            max_segments=16, mesh=build_fleet_mesh(),
        )

    paths = []
    for i, robot in enumerate(robots):
        x0 = 1.0 * i
        robot.state.x, robot.state.y, robot.state.yaw = x0, 0.0, np.pi / 2
        paths.append(np.array([[x0, 0.0], [x0, 3.0]]))
    fleet.set_paths(paths)

    reached = np.zeros(n_robots, bool)
    tick_times = []
    scans = [LaserScanData(ranges=np.full(n_rays, 10.0), angles=angles)] * n_robots
    ranges = np.full((n_robots, n_rays), 10.0)
    for tick in range(80):
        if host_mode:
            results = fleet.tick([r.state for r in robots], scans)
            found = [r["found"] for r in results]
            vx = [r.get("vx", 0.0) for r in results]
            vy = [r.get("vy", 0.0) for r in results]
            om = [r.get("omega", 0.0) for r in results]
            reached |= np.array(
                [r.get("reason") == "goal_reached" for r in results]
            )
        else:
            states = np.array(
                [[r.state.x, r.state.y, r.state.yaw, r.state.speed]
                 for r in robots]
            )
            vels = np.array(
                [[r.state.vx, r.state.vy, r.state.omega] for r in robots]
            )
            out = fleet.tick(states, vels, ranges, angles)
            found, vx, vy, om = out["found"], out["vx"], out["vy"], out["omega"]
            reached |= out["reached"]
        tick_times.append(fleet.last_tick_seconds)
        for i, robot in enumerate(robots):
            if not reached[i] and found[i]:
                robot.set_control(
                    velocity_x=vx[i], velocity_y=vy[i], omega=om[i]
                )
                robot.get_state(dt=0.1)
        if reached.all():
            break
    steady = np.median(tick_times[2:]) if len(tick_times) > 3 else tick_times[-1]
    mode = "host-follower" if host_mode else "device-resident"
    print(
        f"fleet[{mode}]: {int(reached.sum())}/{n_robots} robots reached "
        f"goals in {len(tick_times)} ticks; steady tick {steady * 1e3:.1f} ms "
        f"({n_robots / steady:,.0f} solves/s end-to-end)"
    )
    assert reached.sum() >= n_robots - 1
    print("FLEET DEMO PASSED")
    return 0


def main_peers(n_robots: int = 8, predict: bool = False,
               use_mesh: bool = False):
    """Fleet mutual avoidance: crossing pairs, on-device peer discs.
    With ``predict``, peer discs also advect along their live commanded
    velocities within every rollout (peer motion prediction). With
    ``use_mesh``, the fleet shards over an 8-device virtual CPU mesh —
    mutual avoidance then runs ACROSS chips via one bounded all_gather
    of the [N, 7] peer state per tick."""
    mesh = None
    if use_mesh:
        import jax

        # virtual CPU mesh; requires
        # XLA_FLAGS=--xla_force_host_platform_device_count=8
        jax.config.update("jax_platforms", "cpu")
        if len(jax.devices()) < 8:
            print(
                "run with XLA_FLAGS=--xla_force_host_platform_device_"
                "count=8 for the mesh demo; falling back to 1 device"
            )
        else:
            from kompass_core_tpu.parallel import build_fleet_mesh

            mesh = build_fleet_mesh()
    n_robots = max(2, (n_robots // 2) * 2)
    radius = 0.3
    robots = [
        Robot(
            robot_type=RobotType.DIFFERENTIAL_DRIVE,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([radius, 0.4]),
        )
        for _ in range(n_robots)
    ]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(
            max_vel=4.0, max_acc=3.0, max_decel=3.0, max_steer=np.pi
        ),
    )
    config = DWAConfig(
        max_linear_samples=6,
        max_angular_samples=6,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=3.0,
            goal_distance_weight=1.0,
            smoothness_weight=0.0,
            jerk_weight=0.0,
            obstacles_distance_weight=1.0,
        ),
        prediction_horizon=10,
        control_horizon=2,
        control_time_step=0.1,
    )
    n_rays = 72
    angles = np.linspace(0, 2 * np.pi, n_rays, endpoint=False)
    from kompass_core_tpu.parallel import DeviceFleet

    fleet = DeviceFleet(
        robots, limits, config, scan_rays=n_rays, path_capacity=512,
        max_segments=16, peer_avoidance=True, peer_prediction=predict,
        mesh=mesh,
    )
    # crossing pairs: an X per pair. The second robot starts 1.2 m
    # earlier along its lane, so the two reach the intersection at
    # different times — the follower then only needs to yield, not to
    # solve a perfectly symmetric stand-off (which a reciprocal planner
    # would deadlock on; DWA has no explicit coordination)
    paths = []
    for p in range(n_robots // 2):
        x0 = 6.0 * p
        a, b = robots[2 * p], robots[2 * p + 1]
        a.state.x, a.state.y, a.state.yaw = x0, 0.0, np.pi / 4
        b.state.x, b.state.y, b.state.yaw = x0 + 3.85, -0.85, 3 * np.pi / 4
        paths.append(np.array([[x0, 0.0], [x0 + 3.0, 3.0]]))
        paths.append(np.array([[x0 + 3.85, -0.85], [x0, 3.0]]))
    fleet.set_paths(paths)

    ranges = np.full((n_robots, n_rays), 10.0)
    reached = np.zeros(n_robots, bool)
    min_pair_d = np.inf
    ticks = 0
    for ticks in range(1, 151):
        states = np.array(
            [[r.state.x, r.state.y, r.state.yaw, r.state.speed]
             for r in robots]
        )
        vels = np.array(
            [[r.state.vx, r.state.vy, r.state.omega] for r in robots]
        )
        out = fleet.tick(states, vels, ranges, angles)
        reached |= out["reached"]
        for i, robot in enumerate(robots):
            if not reached[i] and out["found"][i]:
                robot.set_control(
                    velocity_x=out["vx"][i], velocity_y=out["vy"][i],
                    omega=out["omega"][i],
                )
                robot.get_state(dt=0.1)
        xy = np.array([[r.state.x, r.state.y] for r in robots])
        d = np.linalg.norm(xy[:, None] - xy[None, :], axis=-1)
        d[np.arange(n_robots), np.arange(n_robots)] = np.inf
        min_pair_d = min(min_pair_d, float(d.min()))
        if reached.all():
            break
    where = (
        f"sharded over {int(np.prod(mesh.devices.shape))} devices"
        if mesh is not None else "single device"
    )
    print(
        f"fleet[peer-avoidance, {where}]: {int(reached.sum())}/"
        f"{n_robots} robots reached crossing goals in {ticks} ticks; "
        f"closest approach {min_pair_d:.2f} m "
        f"(contact = {2 * radius:.2f} m)"
    )
    assert min_pair_d > 2 * radius, "robots collided!"
    assert reached.sum() >= n_robots - 1
    print("FLEET PEER DEMO PASSED")
    return 0


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    sys.exit(
        main(
            int(args[0]) if args else 100,
            host_mode="--host" in sys.argv,
            peers="--peers" in sys.argv,
            predict="--predict" in sys.argv,
            mesh="--mesh" in sys.argv,
        )
    )
