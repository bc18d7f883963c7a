"""Shard-at-serving-site: one single-device fleet artifact, N devices.

The build box exports the fleet-tick program for a SHARD-sized fleet
(here 4 robots) as a hermetic artifact. The serving box — which may have
any number of chips — loads that one artifact and drives a 4x-larger
fleet by row-chunking the argument tree across its devices
(``serving.sharded_fleet_call``): the tick is row-local per robot (zero
cross-device collectives in the compiled steady state, pinned by
tests/test_scaling_hlo.py),
so multi-chip serving needs no sharded program, no re-trace, and no
mesh-aware export. The demo verifies the sharded outputs are
bit-identical to a monolithic live fleet of the full size.

Runs on the 8-device virtual CPU mesh (4 used):
    python examples/serving_mesh_shard_demo.py
"""

import os as _os
import sys as _sys
import tempfile

import numpy as np

_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))

# the sharding demo needs multiple devices; configure the virtual CPU
# mesh BEFORE the first jax backend initialization
_flags = _os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    _os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
_os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from kompass_core_tpu.utils.runtime import (  # noqa: E402
    enable_persistent_compilation_cache,
)

enable_persistent_compilation_cache()

from kompass_core_tpu.control import (  # noqa: E402
    DWAConfig, TrajectoryCostsWeights,
)
from kompass_core_tpu.models import (  # noqa: E402
    AngularCtrlLimits, LinearCtrlLimits, Robot, RobotCtrlLimits,
    RobotGeometry, RobotType,
)
from kompass_core_tpu.parallel.fleet_v2 import DeviceFleet  # noqa: E402
from kompass_core_tpu.serving import (  # noqa: E402
    export_fleet_tick, load_artifact, sharded_fleet_call,
)

N_SHARD, N_DEV, RAYS = 4, 4, 64


def build_fleet(n):
    robots = [
        Robot(
            robot_type=RobotType.DIFFERENTIAL_DRIVE,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([0.2, 0.4]),
        )
        for _ in range(n)
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
        robots, limits, config, scan_rays=RAYS, path_capacity=512,
        max_segments=16,
    )
    fleet.set_paths([
        np.array([[0.0, 2.0 * i], [4.0, 2.0 * i]]) for i in range(n)
    ])
    fleet.set_scan_angles(
        np.linspace(0, 2 * np.pi, RAYS, endpoint=False)
    )
    n_rows = fleet._n
    fleet._inputs[:n, 0] = 0.1
    fleet._inputs[:n, 1] = 2.0 * np.arange(n)
    fleet._inputs[:n, 7:] = 10.0
    del n_rows
    return fleet


def main():
    devices = jax.devices()[:N_DEV]
    assert len(devices) == N_DEV, (
        "needs the 8-device virtual CPU mesh (run the file directly; it "
        "sets XLA_FLAGS before importing jax)"
    )

    # --- build box: export the shard-sized program --------------------
    shard_fleet = build_fleet(N_SHARD)
    art_path = _os.path.join(tempfile.mkdtemp(), "fleet_shard.ktpuart")
    header = export_fleet_tick(shard_fleet, art_path)
    print(
        f"exported {header['kind']} for {header['meta']['n_robots']} "
        f"robots -> {art_path} ({_os.path.getsize(art_path)} bytes)"
    )

    # --- serving box: one artifact, N_DEV devices ---------------------
    art = load_artifact(art_path)
    full = build_fleet(N_SHARD * N_DEV)  # state lives host/device-side
    args = full.tick_example_args()
    carry, out = sharded_fleet_call(art, args, devices)
    print(
        f"served {out.shape[0]} robots across {N_DEV} devices with the "
        f"{N_SHARD}-robot artifact (one async dispatch per device)"
    )

    # ground truth: the monolithic live program on the full fleet
    live_carry, live_out = full._tick_fn(*args)
    np.testing.assert_array_equal(np.asarray(live_out), out)
    for a, b in zip(live_carry, carry):
        np.testing.assert_array_equal(np.asarray(a), b)
    print("sharded serving outputs are bit-identical to the monolithic "
          "fleet")
    print("SERVING MESH SHARD DEMO PASSED")
    return 0


if __name__ == "__main__":
    _sys.exit(main())
