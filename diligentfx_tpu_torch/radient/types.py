"""Radient public types (the port of the JAX package's radient/types.py) —
the analogue of Radient/interface/RadientTypes.h.

Status codes mirror RADIENT_STATUS_* (RadientTypes.h:59-80) including the
recoverable PENDING / OUT_OF_DATE / NO_GPU_DATA trio the reference uses for
graceful degradation."""
from __future__ import annotations

import enum


class RadientStatus(enum.IntEnum):
    OK = 0
    PENDING = 1            # async work not finished yet — retry later
    OUT_OF_DATE = 2        # consumer's base revision too old — full resync
    NO_GPU_DATA = 3        # host data present, device upload not committed
    INVALID_ARGUMENT = -1
    NOT_FOUND = -2
    FAILED = -3
    UNSUPPORTED = -4


class RadientBackendType(enum.IntEnum):
    """RadientTypes.h:45-51: LOCAL runs in-process on the engine's device;
    REMOTE is the multi-host hook (endpoint = the remote host's address)."""
    LOCAL = 0
    REMOTE = 1


class LoadStatus(enum.IntEnum):
    """Asset load state machine (RadientAssetManagerImpl semantics)."""
    NONE = 0
    QUEUED = 1
    LOADING = 2
    LOADED_HOST = 3     # host data ready, GPU upload pending (NO_GPU_DATA)
    COMMITTED = 4       # device-resident
    FAILED = 5


class RadientError(RuntimeError):
    def __init__(self, status: RadientStatus, msg: str = ""):
        super().__init__(f"{status.name}: {msg}")
        self.status = status
