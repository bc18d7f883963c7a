"""What a measurement needs to know about the card it ran on.

* ``PEAKS``: published peak rates per ``jax.Device.device_kind``, the one
  table every roofline share in this repo divides by. A kind that is not
  in the table is an error, never a default.
* ``query_gpus`` / ``parse_gpu_query``: the card's name and power limit
  (and any other field) as ``nvidia-smi --query-gpu`` reports them, to be
  written beside every number: a card set below its maximum power runs
  slower under load.
"""

import subprocess
from typing import Dict, List, Sequence

# NVIDIA H100 SXM data sheet, dense rates (no sparsity), at the full
# 700 W power limit. "f32" is the rate outside the tensor cores, where
# the elementwise sweeps and the bin-min run.
_H100_SXM = {
    "f32_flops": 67e12,
    "tf32_flops": 495e12,
    "bf16_flops": 989e12,
    "hbm_bytes": 3.35e12,
    "source": "NVIDIA H100 SXM data sheet, dense, 700 W",
}

PEAKS: Dict[str, dict] = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
    "NVIDIA H100": _H100_SXM,
}


def peaks_for(device_kind: str) -> dict:
    """Peak rates of ``device_kind``; KeyError for a kind with no entry."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no peak rates for device kind {device_kind!r}: add its data "
            f"sheet values to kompass_core_tpu/benchmark/device.PEAKS"
        ) from None


GPU_QUERY = ("name", "power.limit")


def parse_gpu_query(text: str, fields: Sequence[str] = GPU_QUERY
                    ) -> List[Dict[str, str]]:
    """Rows of ``nvidia-smi --query-gpu=<fields> --format=csv,noheader``
    output, one dict per card, values stripped."""
    rows = []
    for line in text.strip().splitlines():
        if not line.strip():
            continue
        vals = [v.strip() for v in line.split(",")]
        if len(vals) != len(fields):
            raise ValueError(
                f"nvidia-smi row {line!r} has {len(vals)} fields, "
                f"expected {len(fields)} ({', '.join(fields)})"
            )
        rows.append(dict(zip(fields, vals)))
    return rows


def query_gpus(fields: Sequence[str] = GPU_QUERY) -> str:
    """Raw ``nvidia-smi --query-gpu`` output (csv, no header). Raises when
    nvidia-smi is missing or fails."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={','.join(fields)}",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
