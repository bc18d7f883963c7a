"""AOT serving artifact demo: compile once, ship the program.

Exports the packed DWA solver as a hermetic artifact file
(StableHLO via jax.export), then plays the serving side: reads the
header without deserializing, loads the artifact, and runs a solve —
no tracing path imported, semantics pinned at export time.

Run: python examples/aot_artifact_demo.py
"""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from kompass_core_tpu.utils.runtime import (
    enable_persistent_compilation_cache,
)

enable_persistent_compilation_cache()

from kompass_core_tpu.ops.solver import (  # noqa: E402
    SolverSpec, pack_solver_input, packed_input_size, unpack_solver_output,
)
from kompass_core_tpu.ops.window import sample_velocity_window  # noqa: E402
from kompass_core_tpu.serving import (  # noqa: E402
    export_packed_solver, load_packed_solver, read_artifact_header,
)


def main():
    spec = SolverSpec(
        is_omni=False, n_vx=9, n_vy=1, n_omega=9, max_points=20,
        num_ctrl_points=2, scan_size=64, seg_size=64,
    )
    path = os.path.join(tempfile.gettempdir(), "dwa_solver.ktpuart")

    # ---- build side (CI, release pipeline) ----
    header = export_packed_solver(spec, path)
    size_kb = os.path.getsize(path) / 1024
    print(f"exported {header['kind']} -> {path} ({size_kb:.0f} KiB, "
          f"platforms={header['platforms']}, jax {header['jax_version']})")

    # ---- serving side ----
    print("header (no jax deserialization):",
          read_artifact_header(path)["meta"]["solver_spec"]["scan_size"],
          "scan slots")
    art, spec2 = load_packed_solver(path)

    limits = np.zeros(9, np.float32)
    limits[0:3] = (1.0, 5.0, 10.0)
    limits[6:9] = (2.0, 3.0, 3.0)
    window = sample_velocity_window((0.3, 0.0, 0.0), limits, 0.1, 9, 1, 9,
                                    False)
    n_seg = 50
    seg_x = np.full(64, 1e8, np.float32)
    seg_x[:n_seg] = np.linspace(0, 4.9, n_seg)
    seg_y = np.full(64, 1e8, np.float32)
    seg_y[:n_seg] = 0.0
    seg_arc = np.zeros(64, np.float32)
    seg_arc[:n_seg] = np.linspace(0, 4.9, n_seg)
    obs = np.full((64, 2), 1e8, np.float32)
    obs[0] = [2.0, 0.4]
    params = np.array(
        [0.1, 0.2, 0.05, 2.0, 1.0, 1.0, 0.1, 0.05, 5.0, 0.0, 3.0, 10 / 3],
        np.float32,
    )
    buf = np.zeros(packed_input_size(spec2), np.float32)
    pack_solver_input(
        spec2, buf, params_vec=params, state=(0.0, 0.0, 0.0), window=window,
        obs_xy=obs, obs_count=1, seg_x=seg_x, seg_y=seg_y, seg_arc=seg_arc,
        seg_count=n_seg, seg_total_len=4.9, ref_total_len=4.9,
        active_points=20,
    )
    out = unpack_solver_output(spec2, np.asarray(art.call(buf)))
    found, cost = out[0], out[1]
    print(f"served solve: found={bool(found)} cost={float(cost):.4f}")


if __name__ == "__main__":
    main()
