"""Compiled-HLO scaling proof.

The multi-chip scaling claim is that the steady-state fleet programs are
embarrassingly parallel over the robot axis: compiled over a real mesh,
they must contain ZERO cross-device collectives, so adding chips adds no
communication and per-chip throughput equals the single-chip marginal
cost. These tests pin that property on the optimized HLO itself (the
virtual-CPU-mesh wall-clock efficiency measures host contention, not
communication, and cannot pin it).

The sample-parallel solver is the one deliberately-communicating
program: its deterministic lowest-cost/lowest-rank combine
(pmin + pmin + psum) must compile to exactly all-reduce ops — any
all-gather / all-to-all / collective-permute would mean the partitioner
resharded data we claimed stays chip-local.
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from kompass_core_tpu.benchmark.scaling_proof import (
    count_collectives,
    fleet_solver_hlo,
    fleet_tick_hlo,
    sample_parallel_hlo,
)


@pytest.fixture(scope="module")
def mesh():
    devices = jax.devices()
    assert len(devices) == 8, "conftest must provide 8 virtual devices"
    return Mesh(np.array(devices), axis_names=("robots",))


def test_count_collectives_parses_hlo_ops():
    hlo = """
HloModule jit_tick
%region_2 (a: f32[], b: f32[]) -> f32[] { ... }
ENTRY %main {
  %x = f32[8]{0} parameter(0)
  %ar = f32[8]{0} all-reduce(%x), replica_groups={}, to_apply=%region_2
  %ag = f32[64]{0} all-gather(%x), dimensions={0}
  %cp-start = f32[8]{0} collective-permute-start(%x), source_target_pairs={{0,1}}
  %cp-done = f32[8]{0} collective-permute-done(%cp-start)
  %ags = (f32[8,16]{1,0}, f32[64,16]{1,0}) all-gather-start(%x), dimensions={0}
  %agd = f32[64,16]{1,0} all-gather-done(%ags)
  %ars = (f32[8]{0:T(128)}, f32[8]{0:T(128)}, u32[]{:T(128)}, u32[]{:T(128)}) all-reduce-start(%x), to_apply=%region_2
  %ard = f32[8]{0} all-reduce-done(%ars)
  %fu = f32[8]{0} fusion(%x), kind=kLoop, calls=%all-reduce-helper
  ROOT %r = f32[8]{0} add(%x, %x)
}
"""
    counts = count_collectives(hlo)
    # tuple-shaped async -start forms must count (accelerator HLO uses them
    # for every async collective); -done must not double count; a
    # computation NAME mentioning a collective must not count
    assert counts == {
        "all-reduce": 2,
        "all-gather": 2,
        "collective-permute": 1,
    }


def test_fleet_solver_packed_has_zero_collectives(mesh):
    counts = count_collectives(fleet_solver_hlo(mesh))
    assert counts == {}, (
        f"packed fleet solver sharded over 8 devices must be "
        f"communication-free, found {counts}"
    )


def test_fleet_v2_tick_has_zero_collectives(mesh):
    """The device-resident fleet tick — the serving steady state — must
    stay communication-free. Regression context: the closest-segment
    binary descent was originally a lax.while_loop, whose data-dependent
    condition under a sharded vmap compiles to one scalar all-reduce PER
    ITERATION; it is now statically unrolled (ops/fleet_solver.py)."""
    counts = count_collectives(fleet_tick_hlo(mesh))
    assert counts == {}, (
        f"fleet v2 tick sharded over 8 devices must be "
        f"communication-free, found {counts}"
    )


def test_sample_parallel_compiles_to_all_reduce_only(mesh):
    counts = count_collectives(sample_parallel_hlo(mesh))
    assert set(counts) == {"all-reduce"}, (
        f"sample-parallel combine must use all-reduce only, got {counts}"
    )
    # pmin(local_cost) + pmin(winner_rank) + psum(contribution): XLA may
    # legally fuse adjacent combines, so pin a small closed range rather
    # than the exact count
    assert 1 <= counts["all-reduce"] <= 3


def test_fleet_v2_safety_tick_has_zero_collectives(mesh):
    """The safety-fused tick adds only row-local masked-min work (the
    critical-zone gate); it must not change the zero-collective steady
    state."""
    counts = count_collectives(fleet_tick_hlo(mesh, safety=True))
    assert counts == {}, (
        f"safety-fused fleet tick sharded over 8 devices must be "
        f"communication-free, found {counts}"
    )


def test_fleet_v2_tracked_tick_has_zero_collectives(mesh):
    """The moving-obstacle tick (per-robot tracked movers in the sharded
    input matrix) is row-local like safety; it must not change the
    zero-collective steady state."""
    counts = count_collectives(fleet_tick_hlo(mesh, tracked=2))
    assert counts == {}, (
        f"tracked-mover fleet tick sharded over 8 devices must be "
        f"communication-free, found {counts}"
    )


def test_fleet_v2_split_tracked_tick_has_zero_collectives(mesh):
    """The split mover sweep (narrow moving set beside the static scan
    sweep) is row-local like the tail-slot form; it must keep the
    zero-collective steady state."""
    counts = count_collectives(fleet_tick_hlo(mesh, tracked=2, split=True))
    assert counts == {}, (
        f"split-mover fleet tick sharded over 8 devices must be "
        f"communication-free, found {counts}"
    )


def test_fleet_v2_peer_mesh_tick_has_exactly_one_all_gather(mesh):
    """Mesh-sharded mutual avoidance: the peer state —
    the [N, 7] state+velocity block, N*28 bytes — is the ONLY thing that
    crosses chips, as exactly one all-gather per tick. Any second
    collective would mean the partitioner resharded something we claim
    stays chip-local; zero would mean the peers silently stopped being
    gathered."""
    counts = count_collectives(fleet_tick_hlo(mesh, peers=True))
    assert counts == {"all-gather": 1}, (
        f"mesh peer tick must contain exactly one all-gather and "
        f"nothing else, found {counts}"
    )
