"""Checkpoint service, the port of ``kubeflow_tpu.train.checkpoint`` with the
same surface and the port's own on-disk format.

Layout under ``directory``: one numeric directory per saved step holding
``params.pt`` (the model's parameters), ``opt_state.pt`` (the optimizer's
moments), ``extra_vars.pt`` where the state has any (an image model's
BatchNorm running statistics, so a resumed ResNet keeps them) and
``meta.json`` (step and optimizer count), written
(``torch.save``) into a temporary directory that is renamed into place
only after a ``COMPLETE`` marker is written last. A save torn by a crash
leaves a temporary directory or a step directory without the marker, and
neither is ever restored. Reading orbax checkpoints of the JAX package is
out of scope.

``save`` copies the state to host memory before it returns (the train loop
may go on updating the device tensors) and writes the files on a
background thread; ``wait`` / ``close`` drain it, and a write error is
raised there or by the next ``save``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional

import torch

from kubeflow_tpu_torch.train.trainer import TrainState
from kubeflow_tpu_torch.utils.logging import get_logger

log = get_logger("checkpoint")

_MARKER = "COMPLETE"


def _to_host(tree: Any) -> Any:
    """Detached CPU copies of every tensor of a nested dict."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _copy_into(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Copy ``src``'s tensors into ``dst``'s same-named tensors in place
    (keeping their device and dtype)."""
    if set(dst) != set(src):
        raise ValueError(f"checkpoint keys {sorted(set(src) ^ set(dst))} "
                         "do not match the live state")
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v)
        else:
            with torch.no_grad():
                dst[k].copy_(v)


class CheckpointService:
    """Numeric step directories with a completion marker; keeps the newest
    ``max_to_keep``. ``restore_latest`` returns None when no complete
    checkpoint exists: the auto-resume contract (the runner always calls
    it and starts fresh on None)."""

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 save_interval_steps: int = 1):
        self.directory = os.path.abspath(os.path.expanduser(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ---------------- save ----------------

    def save(self, step: int, state: TrainState) -> bool:
        """Snapshot ``state`` at ``step`` and write it in the background.
        False (nothing saved) when the step is off the save interval or
        already saved."""
        self.wait()
        if step % self.save_interval_steps or step in self.all_steps():
            return False
        payload = {
            "params": _to_host(state.params),
            "opt_state": _to_host({k: v for k, v in state.opt_state.items()
                                   if k != "count"}),
            # A state without extra variables (an LM's; any object with
            # params, opt_state and step) saves none.
            "extra_vars": _to_host(getattr(state, "extra_vars", {})),
            "meta": {"step": int(state.step),
                     "count": int(state.opt_state.get("count", state.step))},
        }
        self._writer = threading.Thread(
            target=self._write, args=(step, payload),
            name=f"checkpoint-{step}")
        self._writer.start()
        return True

    def _write(self, step: int, payload: Dict[str, Any]) -> None:
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        try:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(payload["params"], os.path.join(tmp, "params.pt"))
            torch.save(payload["opt_state"], os.path.join(tmp, "opt_state.pt"))
            if payload["extra_vars"]:
                torch.save(payload["extra_vars"],
                           os.path.join(tmp, "extra_vars.pt"))
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(payload["meta"], f)
            with open(os.path.join(tmp, _MARKER), "w") as f:
                f.write("ok\n")
            os.replace(tmp, os.path.join(self.directory, str(step)))
            log.info("checkpoint saved", kv={"step": step,
                                             "dir": self.directory})
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        except BaseException as e:  # noqa: BLE001 — raised by wait()
            self._error = e

    def wait(self) -> None:
        """Block until the pending write is on disk; re-raise its error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def close(self) -> None:
        self.wait()

    # ---------------- restore ----------------

    def all_steps(self) -> List[int]:
        """Steps with a complete checkpoint, oldest first."""
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(
                    os.path.join(self.directory, name, _MARKER)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load(self, step: int, name: str):
        return torch.load(os.path.join(self.directory, str(step), name),
                          map_location="cpu", weights_only=True)

    def restore_latest(self, state: TrainState) -> Optional[TrainState]:
        """Restore the newest complete checkpoint INTO ``state``'s tensors
        (the model's parameters, the optimizer moments and the extra
        variables, in place, on their devices) and return it with the
        saved step; None when there is none."""
        self.wait()
        step = self.latest_step()
        if step is None:
            return None
        with open(os.path.join(self.directory, str(step), "meta.json")) as f:
            meta = json.load(f)
        _copy_into(state.params, self._load(step, "params.pt"))
        moments = {k: v for k, v in state.opt_state.items() if k != "count"}
        _copy_into(moments, self._load(step, "opt_state.pt"))
        extra = getattr(state, "extra_vars", {})
        if extra:
            _copy_into(extra, self._load(step, "extra_vars.pt"))
        log.info("checkpoint restored", kv={"step": step})
        return TrainState(step=meta["step"], params=state.params,
                          opt_state={**moments, "count": meta["count"]},
                          extra_vars=extra)

    def restore_params_latest(self) -> Optional[Dict[str, Any]]:
        """{"params": state dict (CPU tensors), "step": int} of the newest
        complete checkpoint, reading only ``params.pt``: serving never
        loads the optimizer moments. None when there is none."""
        self.wait()
        step = self.latest_step()
        if step is None:
            return None
        log.info("checkpoint params restored", kv={"step": step})
        return {"params": self._load(step, "params.pt"), "step": step}
