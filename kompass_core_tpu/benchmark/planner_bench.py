"""Planner benchmark: every reference-bound geometric planner on the
recorded turtlebot map, mirroring the reference's ``test_ompl.py`` run
whose output is committed at
``tests/resources/reference/ompl/test_results_geometric_ref.csv``
(columns: method, solved, solution_time, solution_len, ...).

Emits ``PLANNERS_BENCH.json``: per-planner solved / solve seconds /
solution length next to the reference's recorded length for the same
(map, start, goal), plus the length ratio. Lengths are comparable
(same problem); times are not (different hardware + algorithms), they
are recorded for completeness.

Runs on CPU: global planning is a host-side workload in the reference
too (OMPL is CPU-only), and the JAX planner kernels are small
fixed-capacity programs that compile in seconds on CPU.

Run: PYTHONPATH=. python -m kompass_core_tpu.benchmark.planner_bench
"""

import csv
import json
import os
import sys
import time


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main(out_path="PLANNERS_BENCH.json"):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from kompass_core_tpu.models import Robot, RobotGeometry, RobotType
    from kompass_core_tpu.planning import GlobalPlanner, GlobalPlannerConfig

    res = os.path.join(
        os.path.dirname(__file__), "..", "..", "tests", "resources",
        "reference", "ompl",
    )
    with open(os.path.join(res, "map_meta.json")) as f:
        map_meta = json.load(f)
    map_cloud = np.load(os.path.join(res, "turtlebot_map.npy"))
    ref_rows = {}
    with open(os.path.join(res, "test_results_geometric_ref.csv")) as f:
        for row in csv.DictReader(f):
            ref_rows[row["method"].rsplit(".", 1)[-1]] = row

    robot = Robot(
        robot_type=RobotType.DIFFERENTIAL_DRIVE,
        geometry_type=RobotGeometry.Type.CYLINDER,
        geometry_params=np.array([0.1, 0.4]),
    )

    results = []
    for name, ref in ref_rows.items():
        cfg = GlobalPlannerConfig(
            planner_id=name, num_samples=512, seed=2,
            connection_radius=1.5, max_iterations=1024, step_size=0.3,
            planning_timeout=30.0,
        )
        planner = GlobalPlanner(robot, config=cfg)
        planner.setup_problem(
            map_meta, -1.88, -0.38, 0.3, 0.59, 0.73, 0.0, map_cloud
        )
        t0 = time.monotonic()
        path = planner.solve()
        dt = time.monotonic() - t0
        # the reference's own run failed some planners (e.g. LazyPRM:
        # solved=False, len 0.0) — no length to compare there
        ref_len = float(ref["solution_len"])
        ref_solved = ref["solved"].strip().lower() == "true" and ref_len > 0
        row = {
            "planner": name,
            "solved": path is not None,
            "solution_time_s": round(dt, 4),
            "solution_len": round(planner.path_cost, 4) if path is not None
            else None,
            "ref_solved": ref_solved,
            "ref_solution_len": round(ref_len, 4) if ref_solved else None,
            "len_ratio_vs_ref": round(planner.path_cost / ref_len, 3)
            if (path is not None and ref_solved) else None,
        }
        results.append(row)
        log(f"{name}: solved={row['solved']} {dt:.2f}s "
            f"len={row['solution_len']} (ref {row['ref_solution_len']})")

    solved = [r for r in results if r["solved"]]
    ratios = [r["len_ratio_vs_ref"] for r in solved
              if r["len_ratio_vs_ref"] is not None]
    summary = {
        "workload": "turtlebot map, start (-1.88,-0.38) goal (0.59,0.73), "
                    "reference test_ompl.py problem",
        "note": "solution_len comparable to the reference (same problem); "
                "times are different hardware/algorithms (first solve "
                "includes jit compile)",
        "planners_total": len(results),
        "planners_solved": len(solved),
        "planners_ref_solved": sum(r["ref_solved"] for r in results),
        # None (JSON null) when no solved planner has a reference
        # counterpart — np.median([]) is NaN, which is invalid JSON
        "median_len_ratio_vs_ref": (
            round(float(np.median(ratios)), 3) if len(ratios) else None
        ),
        "results": results,
    }
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: summary[k] for k in
                      ("planners_total", "planners_solved",
                       "median_len_ratio_vs_ref")}))


if __name__ == "__main__":
    main()
