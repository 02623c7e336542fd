"""Logging setup — the port of ``bigdl_tpu.utils.log``.

Plain ``logging`` with a single concise formatter on the package's root
logger; in a multi-process job only process 0 logs at INFO by default
(the others at WARNING).  The process id comes from
``BIGDL_TPU_PROCESS_ID``, else from ``torch.distributed`` when a
process group is up, else 0.  Unlike the JAX package's, records still
propagate to the root logger, and the formatter is added only where
the root has no handler of its own, so an application's (or a test's)
logging setup sees the port's records once."""

import logging
import os
import sys

_CONFIGURED = False


def _is_primary() -> bool:
    pid = os.environ.get("BIGDL_TPU_PROCESS_ID")
    if pid is not None:
        return int(pid) == 0
    try:
        import torch.distributed as dist

        return not (dist.is_available() and dist.is_initialized()) \
            or dist.get_rank() == 0
    except Exception:
        return True


def get_logger(name: str = "bigdl_tpu_torch") -> logging.Logger:
    global _CONFIGURED
    logger = logging.getLogger(name)
    if not _CONFIGURED:
        root = logging.getLogger("bigdl_tpu_torch")
        if not logging.getLogger().handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname)s %(name)s: %(message)s",
                "%H:%M:%S"))
            root.addHandler(handler)
        level = os.environ.get("BIGDL_TPU_LOG_LEVEL", "INFO").upper()
        root.setLevel(level if _is_primary() else "WARNING")
        _CONFIGURED = True
    return logger
