"""Training worker entry point, the port of ``kubeflow_tpu.train.runner``:
``python -m kubeflow_tpu_torch.train.runner``.

Reads the same ``KFTPU_*`` env contract (:func:`env_config`) and trains
one process on one device: ``cuda`` unless ``KFTPU_PLATFORM=cpu``
(without a card it raises). Supported: ``KFTPU_MODEL`` /
``KFTPU_MODEL_KW``, ``KFTPU_HPARAMS`` (TrainConfig overrides),
``KFTPU_ATTN_IMPL``, ``KFTPU_TRAIN_STEPS``, ``KFTPU_BATCH_PER_HOST``,
``KFTPU_SEQ_LEN``, ``KFTPU_CHECKPOINT_DIR`` + ``KFTPU_CHECKPOINT_EVERY``
(auto-resume from the newest complete checkpoint), ``KFTPU_EVAL_EVERY`` /
``KFTPU_EVAL_BATCHES``, ``KFTPU_SEED``, the native loader
(``KFTPU_LOADER=native``; ``KFTPU_DATA_PATH`` and ``KFTPU_EVAL_DATA_PATH``
name int32 token files, rows of ``seq_len + 1`` tokens; without a
toolchain it falls back to the synthetic stream, unless a corpus was
named) and the termination log (``KFTPU_TERMINATION_LOG``:
``tokens_per_sec``, ``steps``, ``loss``, ``eval_*``). Multi-process
gangs, meshes with an axis above 1 and the trace/profile directories
raise ``NotImplementedError`` naming the slice that brings them.

On the card each batch goes to the device through pinned staging buffers
with a non-blocking copy (:class:`DeviceFeed`), so a fresh batch does not
wait for the step before it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import torch

from kubeflow_tpu_torch.utils.logging import get_logger

log = get_logger("runner")


def env_config() -> dict:
    """The JAX runner's env contract, read the same way."""
    mesh = json.loads(os.environ.get("KFTPU_MESH", "{}") or "{}")
    hparams = json.loads(os.environ.get("KFTPU_HPARAMS", "{}") or "{}")
    return {
        "hparams": hparams,
        "termination_log": os.environ.get(
            "KFTPU_TERMINATION_LOG", "/dev/termination-log"),
        "coordinator": os.environ.get("KFTPU_COORDINATOR_ADDRESS", ""),
        "num_processes": int(os.environ.get("KFTPU_NUM_PROCESSES", "1")),
        "process_id": int(os.environ.get("KFTPU_PROCESS_ID", "0")),
        "slice_type": os.environ.get("KFTPU_SLICE_TYPE", ""),
        "mesh": mesh,
        "attn_impl": os.environ.get("KFTPU_ATTN_IMPL", "full"),
        "model": os.environ.get("KFTPU_MODEL", "llama-tiny"),
        "model_kw": json.loads(
            os.environ.get("KFTPU_MODEL_KW", "{}") or "{}"),
        "checkpoint_dir": os.environ.get("KFTPU_CHECKPOINT_DIR", ""),
        "restart_count": int(os.environ.get("KFTPU_RESTART_COUNT", "0")),
        "steps": int(os.environ.get("KFTPU_TRAIN_STEPS", "100")),
        "batch_per_host": int(os.environ.get("KFTPU_BATCH_PER_HOST", "8")),
        "seq_len": int(os.environ.get("KFTPU_SEQ_LEN", "1024")),
        "checkpoint_every": int(os.environ.get("KFTPU_CHECKPOINT_EVERY", "50")),
        "trace_dir": os.environ.get("KFTPU_TRACE_DIR", ""),
        "trace_steps": int(os.environ.get("KFTPU_TRACE_STEPS", "5")),
        "profile_dir": os.environ.get("KFTPU_PROFILE_DIR", ""),
        "loader": os.environ.get("KFTPU_LOADER", ""),
        "data_path": os.environ.get("KFTPU_DATA_PATH", ""),
        "eval_every": int(os.environ.get("KFTPU_EVAL_EVERY", "0")),
        "eval_batches": int(os.environ.get("KFTPU_EVAL_BATCHES", "8")),
        "eval_data_path": os.environ.get("KFTPU_EVAL_DATA_PATH", ""),
        "seed": int(os.environ.get("KFTPU_SEED", "0")),
    }


def _check_supported(cfg: dict) -> None:
    """Raise on the parts of the contract that later slices port."""
    if cfg["num_processes"] > 1:
        raise NotImplementedError(
            f"KFTPU_NUM_PROCESSES={cfg['num_processes']} is not supported by "
            "the PyTorch port yet (the multi-GPU slice): it trains one "
            "process on one device")
    wide = {k: v for k, v in (cfg["mesh"] or {}).items() if int(v) > 1}
    if wide:
        raise NotImplementedError(
            f"KFTPU_MESH axes {wide} are not supported by the PyTorch port "
            "yet (the multi-GPU slice): every axis must be 1 or -1")
    for key, env in (("trace_dir", "KFTPU_TRACE_DIR"),
                     ("profile_dir", "KFTPU_PROFILE_DIR")):
        if cfg.get(key):
            raise NotImplementedError(
                f"{env}={cfg[key]!r} is not supported by the PyTorch port "
                "yet (the tooling slice)")


class DeviceFeed:
    """Host batches (numpy) to device tensors. On the card each key's
    batch is copied into one of two pinned staging buffers and sent with
    ``non_blocking=True``: a copy from pageable memory would wait for the
    queued step first. A buffer is rewritten only once the copy that last
    read it (two batches back) has finished. Elsewhere a plain copy."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._slots = ({}, {})
        self._done = [None, None]
        self._turn = 0

    def __call__(self, batch: dict) -> dict:
        if self.device.type != "cuda":
            return {k: torch.as_tensor(v).to(self.device)
                    for k, v in batch.items()}
        turn, self._turn = self._turn, self._turn ^ 1
        if self._done[turn] is not None:
            self._done[turn].synchronize()
        slot, out = self._slots[turn], {}
        for k, v in batch.items():
            src = torch.as_tensor(v)
            buf = slot.get(k)
            if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
                buf = slot[k] = torch.empty(src.shape, dtype=src.dtype,
                                            pin_memory=True)
            buf.copy_(src)
            out[k] = buf.to(self.device, non_blocking=True)
        self._done[turn] = torch.cuda.Event()
        self._done[turn].record()
        return out


def run(cfg: dict) -> int:
    from kubeflow_tpu_torch.models import get_model
    from kubeflow_tpu_torch.train.checkpoint import CheckpointService
    from kubeflow_tpu_torch.train.data import (
        SyntheticTextConfig,
        synthetic_text,
    )
    from kubeflow_tpu_torch.train.trainer import TrainConfig, Trainer
    from kubeflow_tpu_torch.utils.device import platform_device

    _check_supported(cfg)
    device = platform_device()
    log.info("worker up", kv={"device": str(device),
                              "restart": cfg["restart_count"]})
    with torch.device(device):
        model, model_cfg = get_model(cfg["model"], **cfg.get("model_kw", {}))
    tc = TrainConfig(task="lm", attn_impl=cfg["attn_impl"],
                     total_steps=cfg["steps"])
    # HPO overrides (TrainConfig is frozen: rebuild). A swept total_steps
    # changes the steps actually run, not just the decay schedule.
    overrides = {}
    for k, v in cfg.get("hparams", {}).items():
        if hasattr(tc, k):
            cur = getattr(tc, k)
            overrides[k] = type(cur)(v) if cur is not None else v
    if overrides:
        tc = dataclasses.replace(tc, **overrides)
        if "total_steps" in overrides:
            cfg["steps"] = tc.total_steps
    trainer = Trainer(model, tc, device=device)
    batch_size = cfg["batch_per_host"]
    loader = None
    if cfg["loader"] == "native" or cfg["data_path"]:
        from kubeflow_tpu_torch.train.native_loader import (
            NativeLoaderUnavailable,
            NativeTokenLoader,
        )

        try:
            # seq_len + 1: the LM step shifts inputs and labels, so rows
            # carry one extra token (synthetic_text's contract too).
            loader = NativeTokenLoader(
                batch_size=batch_size, seq_len=cfg["seq_len"] + 1,
                vocab_size=model_cfg.vocab_size,
                token_file=cfg["data_path"], seed=cfg["seed"])
            log.info("native loader active",
                     kv={"data": cfg["data_path"] or "synthetic"})
        except NativeLoaderUnavailable as e:
            if cfg["data_path"]:
                raise      # a requested corpus must not silently degrade
            log.info("native loader unavailable; synthetic fallback",
                     kv={"err": str(e)})
    it = loader if loader is not None else synthetic_text(
        SyntheticTextConfig(batch_size=batch_size, seq_len=cfg["seq_len"],
                            vocab_size=model_cfg.vocab_size,
                            seed=cfg["seed"]))
    # The JAX runner draws its first batch to shape the init; drawing it
    # here too keeps the two runs on the same batch sequence.
    next(it)
    state = trainer.init_state(cfg["seed"])

    def run_eval(st):
        """Score the held-out set: a fresh iterator per call (same seed)
        keeps successive evals comparable."""
        if cfg["eval_data_path"]:
            from kubeflow_tpu_torch.train.native_loader import (
                NativeTokenLoader,
            )

            ev = NativeTokenLoader(
                batch_size=batch_size, seq_len=cfg["seq_len"] + 1,
                vocab_size=model_cfg.vocab_size,
                token_file=cfg["eval_data_path"], seed=7919 + cfg["seed"])
        else:
            ev = synthetic_text(SyntheticTextConfig(
                batch_size=batch_size, seq_len=cfg["seq_len"],
                vocab_size=model_cfg.vocab_size, seed=7919 + cfg["seed"]))
        try:
            return trainer.evaluate(st, (next(ev) for _ in
                                         range(cfg["eval_batches"])))
        finally:
            ev.close()

    ckpt = None
    if cfg["checkpoint_dir"]:
        ckpt = CheckpointService(cfg["checkpoint_dir"])
        restored = ckpt.restore_latest(state)
        if restored is not None:
            state = restored
            log.info("auto-resumed", kv={"step": state.step})

    start_step = state.step
    last_eval = None               # (step, metrics) of the newest eval
    metrics = None
    feed = DeviceFeed(device)
    t0 = time.time()
    try:
        for i in range(start_step, cfg["steps"]):
            state, metrics = trainer.step(state, feed(next(it)))
            if ckpt is not None and (i + 1) % cfg["checkpoint_every"] == 0:
                ckpt.save(state.step, state)
            if cfg["eval_every"] > 0 and (i + 1) % cfg["eval_every"] == 0:
                last_eval = (i + 1, run_eval(state))
                log.info("eval", kv={"step": i + 1, **{
                    k: f"{v:.4f}" for k, v in last_eval[1].items()}})
            if (i + 1) % 10 == 0:
                tps = (batch_size * cfg["seq_len"] * (i + 1 - start_step)
                       / max(time.time() - t0, 1e-9))
                log.info("step", kv={"step": i + 1,
                                     "loss": f"{float(metrics['loss']):.4f}",
                                     "tokens_per_sec": f"{tps:.0f}"})
        ran_steps = cfg["steps"] > start_step
        final_loss = float(metrics["loss"]) if ran_steps else None
        tokens_per_sec = (batch_size * cfg["seq_len"]
                          * (cfg["steps"] - start_step)
                          / max(time.time() - t0, 1e-9))
        if ckpt is not None:
            ckpt.save(state.step, state)
    finally:
        if ckpt is not None:
            ckpt.close()
        if loader is not None:
            log.info("native loader done", kv={
                "batches": loader.batches_produced, "stalls": loader.stalls})
            loader.close()
    final_eval = {}
    if cfg["eval_every"] > 0 and ran_steps:
        # Reuse the in-loop result when it already scored the final state.
        if last_eval is not None and last_eval[0] == cfg["steps"]:
            final_eval = last_eval[1]
        else:
            final_eval = run_eval(state)
    report = {"tokens_per_sec": tokens_per_sec, "steps": cfg["steps"]}
    # A resume at or past the final step runs no step and reports no loss.
    if ran_steps:
        report["loss"] = final_loss
    report.update({f"eval_{k}": v for k, v in final_eval.items()})
    _report_termination(cfg["termination_log"], report)
    log.info("training complete", kv={
        "steps": cfg["steps"],
        "final_loss": f"{final_loss:.4f}" if ran_steps
        else "n/a (resumed past final step)"})
    return 0


def _report_termination(path: str, metrics: dict) -> None:
    """Write the final-metrics report to the termination-message path.
    Best-effort: a missing /dev/termination-log (non-container runs) is
    not an error."""
    try:
        with open(path, "w") as f:
            json.dump(metrics, f)
    except OSError:
        log.info("termination log unavailable", kv={"path": path})


def main() -> int:
    return run(env_config())


if __name__ == "__main__":
    sys.exit(main())
