"""kompass_core_tpu — a sampling-based local-planning engine in JAX.

A from-scratch re-design of the capabilities of ``kompass-core``
(GPU/SYCL robot navigation library) as XLA tensor programs, run on
NVIDIA GPUs:

- the full DWA control tick (velocity-window sampling, kinematic rollout,
  collision masking, multi-objective cost evaluation, argmin) is a single
  jitted XLA tensor program over SoA arrays (``ops/``),
- host-side path machinery (interpolation, segmentation, closest-point
  tracking) lives in NumPy (``datatypes/``, ``control/``),
- occupancy-grid mapping and critical-zone safety checks are gather-based
  tensor kernels fused into the control step (``mapping/``, ``ops/``),
- multi-robot fleets scale over a ``jax.sharding.Mesh``
  (``parallel/``).

Reference parity: semantics follow kompass-core's CPU implementation
(see per-module docstrings citing reference file:line).
"""

__version__ = "0.1.0"

from . import utils  # noqa: F401
from .utils.logger import (  # noqa: F401
    get_available_accelerators,
    set_log_file,
    set_log_level,
)

# reference-compatible alias (kompass_core.set_logging_level)
set_logging_level = set_log_level
