"""Structured key=value logging, the API of kubeflow_tpu.utils.logging.

``get_logger(name).info("msg", kv={...})`` renders ``msg k=v ...``;
``KFTPU_LOG_LEVEL`` sets the level of the ``kubeflow_tpu_torch`` logger
tree. Handlers an embedding application installed are left alone.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
from typing import Any

_configured = False
_lock = threading.Lock()


class _KVAdapter(logging.LoggerAdapter):
    def process(self, msg: str, kwargs: Any):
        extra = kwargs.pop("kv", None) or {}
        merged = {**(self.extra or {}), **extra}
        if merged:
            msg = f"{msg} " + " ".join(f"{k}={v}" for k, v in merged.items())
        return msg, kwargs


def _configure() -> None:
    global _configured
    with _lock:
        if _configured:
            return
        level = os.environ.get("KFTPU_LOG_LEVEL", "INFO").strip().upper()
        if level not in ("CRITICAL", "ERROR", "WARNING", "INFO", "DEBUG"):
            level = "INFO"
        root = logging.getLogger("kubeflow_tpu_torch")
        root.setLevel(level)
        if not root.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname).1s %(name)s %(message)s"))
            root.addHandler(handler)
        root.propagate = False
        _configured = True


def get_logger(name: str, **kv: Any) -> _KVAdapter:
    _configure()
    return _KVAdapter(logging.getLogger(f"kubeflow_tpu_torch.{name}"), kv)
