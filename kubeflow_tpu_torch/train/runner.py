"""Training worker entry point, the port of ``kubeflow_tpu.train.runner``:
``python -m kubeflow_tpu_torch.train.runner``.

Reads the same ``KFTPU_*`` env contract (:func:`env_config`) and trains
one process on one device: ``cuda`` unless ``KFTPU_PLATFORM=cpu``
(without a card it raises). Supported: ``KFTPU_MODEL`` /
``KFTPU_MODEL_KW``, ``KFTPU_HPARAMS`` (TrainConfig overrides),
``KFTPU_ATTN_IMPL``, ``KFTPU_TRAIN_STEPS``, ``KFTPU_BATCH_PER_HOST``,
``KFTPU_SEQ_LEN``, ``KFTPU_CHECKPOINT_DIR`` + ``KFTPU_CHECKPOINT_EVERY``
(auto-resume from the newest complete checkpoint), ``KFTPU_EVAL_EVERY`` /
``KFTPU_EVAL_BATCHES``, ``KFTPU_SEED`` and the termination log
(``KFTPU_TERMINATION_LOG``: ``tokens_per_sec``, ``steps``, ``loss``,
``eval_*``). Multi-process gangs, meshes with an axis above 1, the native
loader and its corpora, and the trace/profile directories raise
``NotImplementedError`` naming the slice that brings them.
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
    for key, env, slice_ in (
            ("loader", "KFTPU_LOADER", "native loader"),
            ("data_path", "KFTPU_DATA_PATH", "native loader"),
            ("eval_data_path", "KFTPU_EVAL_DATA_PATH", "native loader"),
            ("trace_dir", "KFTPU_TRACE_DIR", "tooling"),
            ("profile_dir", "KFTPU_PROFILE_DIR", "tooling")):
        if cfg.get(key):
            raise NotImplementedError(
                f"{env}={cfg[key]!r} is not supported by the PyTorch port "
                f"yet (the {slice_} slice)")


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
    it = synthetic_text(SyntheticTextConfig(
        batch_size=batch_size, seq_len=cfg["seq_len"],
        vocab_size=model_cfg.vocab_size, seed=cfg["seed"]))
    # The JAX runner draws its first batch to shape the init; drawing it
    # here too keeps the two runs on the same batch sequence.
    next(it)
    state = trainer.init_state(cfg["seed"])

    def run_eval(st):
        """Score the held-out set: a fresh stream per call (same seed)
        keeps successive evals comparable."""
        ev = synthetic_text(SyntheticTextConfig(
            batch_size=batch_size, seq_len=cfg["seq_len"],
            vocab_size=model_cfg.vocab_size, seed=7919 + cfg["seed"]))
        return trainer.evaluate(st, (next(ev) for _ in
                                     range(cfg["eval_batches"])))

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
    t0 = time.time()
    try:
        for i in range(start_step, cfg["steps"]):
            batch = {k: torch.as_tensor(v).to(device)
                     for k, v in next(it).items()}
            state, metrics = trainer.step(state, batch)
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
