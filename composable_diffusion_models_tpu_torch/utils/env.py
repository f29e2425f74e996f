"""Environment switches: the port's copy of
``composable_diffusion_models_tpu.utils.env``."""

from __future__ import annotations

import os
import socket


def is_cluster() -> bool:
    """Hostname/env switch used to re-root output paths on shared infra
    (parity: is_cluster, src/utils/tools.py:39-42)."""
    if os.environ.get("CDX_CLUSTER"):
        return True
    host = socket.gethostname().lower()
    return any(tag in host for tag in ("cluster", "node", "tpu-vm"))


def tiny_subset(n: int, sanity: bool, cap: int = 8) -> int:
    """Dataset-size cap for the --sanity fast path (parity: tiny_subset,
    src/utils/tools.py:44-47)."""
    return min(n, cap) if sanity else n
