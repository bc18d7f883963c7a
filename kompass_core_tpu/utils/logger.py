"""Package logging controls + accelerator enumeration.

Role of the reference's singleton Logger (``utils/logger.h:17-80``, exposed
as ``set_log_level`` / ``set_log_file`` in ``bindings/bindings.cpp:37-46``)
and ``get_available_accelerators`` (``gpu_check.cpp:7-22``).
"""

import logging
from typing import List, Optional

_logger = logging.getLogger("kompass_core_tpu")
_file_handler: Optional[logging.FileHandler] = None


def set_log_level(level: str) -> None:
    _logger.setLevel(level.upper())


def set_log_file(file_path: str) -> None:
    """Attach (or move) a file sink for package logs."""
    global _file_handler
    if _file_handler is not None:
        _logger.removeHandler(_file_handler)
    _file_handler = logging.FileHandler(file_path)
    _file_handler.setFormatter(
        logging.Formatter("[%(asctime)s] [%(levelname)s] %(message)s")
    )
    _logger.addHandler(_file_handler)


def get_available_accelerators() -> List[str]:
    """Enumerate JAX devices."""
    import jax

    return [f"{d.platform}:{d.id} {d.device_kind}" for d in jax.devices()]
