"""One-device trainer, the port of ``kubeflow_tpu.train.trainer``.

``Trainer.step`` runs the LM forward and loss, the backward (through the
flash kernels on the card), optional gradient accumulation, global-norm
clipping and the optimizer update. Schedules and optimizers follow optax's
semantics exactly, written as plain functions on tensors (``torch.optim``
indexes steps and clips differently):

- the schedule is evaluated at the update count BEFORE the update, so the
  first update runs at ``schedule(0)`` (0 for the warmup schedules: step 1
  applies a zero update, weight decay included);
- ``clip_by_global_norm`` scales by ``max_norm / norm`` only when
  ``norm >= max_norm``, with no epsilon; the reported ``grad_norm`` is the
  norm of the unclipped gradients;
- the optimizer runs in f32 whatever the parameter dtype (the JAX
  package's ``_f32_moments``): updates come from f32 casts of grads and
  params, nu is f32, mu is stored in ``mu_dtype`` but bias-corrected from
  its f32 value before the cast, and ``p + u`` is formed in f32 and cast
  back to p's dtype;
- a MoE model's load-balancing loss joins the loss as the JAX trainer
  adds it: ``aux_loss_weight`` (the TrainConfig's, else the model
  config's) times the layers' mean aux (``Llama.forward(return_aux=
  True)``), per microbatch; ``aux_loss`` reports the mean, and eval
  leaves it out;
- ``task="image"`` trains a classifier (``models/resnet.py``,
  ``models/vit.py``) on {"inputs": [B, H, W, 3], "labels": [B]}
  batches: the cross-entropy of ``model(images, train=True)`` without
  z-loss, accumulated weighted by rows; the model's buffers (a ResNet's
  BatchNorm running statistics, the JAX ``batch_stats``) are the state's
  ``extra_vars``, updated in place by each microbatch's forward in turn,
  and eval normalises with them (``train=False``).

The port updates the model's parameters IN PLACE (no second copy of the
parameters or of the updates is held): on the card every tensor in one
launch of K5 after one launch for the norm (``ops/optimizer.py``), on the
CPU tensor by tensor. adafactor takes K11 (``ops/adafactor.py``), which
computes the norm itself from the sums of g^2 its moments take (no K5
launch); its factored moments and block RMS follow the JAX leaves
(``models/layout.py::jax_leaves``), and it mirrors the reference's weight
decay, added after the learning rate (each step scales every weight by
1 - weight_decay, even at lr = 0; ROADMAP.md Queue 3). Its optimizer state
is a dict of tensors. Unlike the JAX trainer there is no mesh: one
process, one device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
from torch.profiler import record_function

from kubeflow_tpu_torch.models.layout import JaxLeaf, jax_leaves
from kubeflow_tpu_torch.ops import adafactor
from kubeflow_tpu_torch.ops import optimizer as fused
from kubeflow_tpu_torch.train.losses import (
    chunked_cross_entropy,
    cross_entropy_stats,
)
from kubeflow_tpu_torch.utils.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.utils.logging import get_logger

log = get_logger("train")

Schedule = Callable[[int], float]
OptState = Dict[str, Any]

#: Sequence-parallel attention names of the JAX trainer and what they run
#: on one device (no sequence axis): "sp_auto" picks flash there, "ring"
#: and "ulysses" fall through to the full reference.
_ONE_DEVICE_ATTN = {"flash": "flash", "full": "full", "sp_auto": "flash",
                    "ring": "full", "ulysses": "full"}


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: clip the count to [0, steps], interpolate."""
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return schedule


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    """optax.cosine_decay_schedule with exponent 1."""
    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        decay = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init * ((1.0 - alpha) * decay + alpha)
    return schedule


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """optax.join_schedules with one boundary: the second schedule sees the
    count relative to the boundary."""
    return lambda count: (first(count) if count < boundary
                          else second(count - boundary))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    z_loss_weight: float = 1e-4
    # "lm" (next-token) or "image" (classification) step semantics.
    task: str = "lm"
    # MoE aux loss weight; 0 takes the model config's (Mixtral's 0.02).
    aux_loss_weight: float = 0.0
    attn_impl: str = "full"
    # Adam first-moment dtype ("bfloat16" halves mu's memory; "" keeps
    # f32). The variance always stays f32.
    mu_dtype: str = ""
    # >0 fuses lm_head + cross-entropy blockwise over tokens
    # (losses.chunked_cross_entropy): [B, S, V] logits never materialise.
    loss_chunk: int = 0
    # >1 splits each step's batch into this many microbatches run one after
    # another, gradients accumulated in f32 and weighted by valid tokens.
    grad_accum_steps: int = 1
    # adamw | lion | adafactor | sgd (adafactor ignores b1, b2 and
    # mu_dtype, as the JAX trainer's does).
    optimizer: str = "adamw"
    # warmup_cosine | warmup_linear | constant | rsqrt, as the JAX trainer.
    lr_schedule: str = "warmup_cosine"

    def make_schedule(self) -> Schedule:
        """Learning rate as a function of the update count (optax's
        schedules, in float64 on the host)."""
        peak, w = self.learning_rate, max(1, self.warmup_steps)
        total = max(self.total_steps, w + 1)
        if self.lr_schedule == "warmup_cosine":
            return _join(_linear(0.0, peak, w),
                         _cosine(peak, total - w, 0.1 if peak else 0.0), w)
        if self.lr_schedule == "warmup_linear":
            return _join(_linear(0.0, peak, w),
                         _linear(peak, peak * 0.1, total - w), w)
        if self.lr_schedule == "constant":
            return _join(_linear(0.0, peak, w), lambda count: peak, w)
        if self.lr_schedule == "rsqrt":
            def rsqrt(count: int) -> float:
                warm = min(count / w, 1.0)
                return peak * warm * math.sqrt(w / max(count, w))
            return rsqrt
        raise ValueError(
            f"unknown lr_schedule {self.lr_schedule!r} "
            "(warmup_cosine | warmup_linear | constant | rsqrt)"
        )

    def make_optimizer(self, leaves: Optional[Dict[str, JaxLeaf]] = None
                       ) -> "Optimizer":
        """The optimizer; ``leaves`` (adafactor only) maps each parameter
        to its JAX leaf, each parameter its own leaf when None."""
        if self.optimizer not in ("adamw", "lion", "adafactor", "sgd"):
            raise ValueError(
                f"unknown optimizer {self.optimizer!r} "
                "(adamw | lion | adafactor | sgd)"
            )
        return Optimizer(self, leaves)


class Optimizer:
    """clip_by_global_norm then adamw, lion, adafactor or sgd (nesterov
    trace with decoupled decay), with optax's arithmetic, applied in place.

    State: {"count": int, "mu": {name: tensor}, "nu": {name: tensor}} for
    adamw; "mu" alone for lion; "trace" for sgd; "v_row", "v_col" and "v"
    for adafactor (``ops/adafactor.py::init_state``)."""

    def __init__(self, cfg: TrainConfig,
                 leaves: Optional[Dict[str, JaxLeaf]] = None):
        self.cfg = cfg
        self.leaves = leaves
        self.schedule = cfg.make_schedule()
        self.mu_dtype = (getattr(torch, cfg.mu_dtype) if cfg.mu_dtype
                         else torch.float32)

    def _leaves(self, params) -> Dict[str, JaxLeaf]:
        return self.leaves or adafactor.default_leaves(params)

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        if self.cfg.optimizer == "adafactor":
            return adafactor.init_state(params, self._leaves(params))
        zeros = {n: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for n, p in params.items()}
        if self.cfg.optimizer == "sgd":
            return {"count": 0, "trace": zeros}
        mu = {n: torch.zeros(p.shape, dtype=self.mu_dtype, device=p.device)
              for n, p in params.items()}
        if self.cfg.optimizer == "lion":
            return {"count": 0, "mu": mu}
        return {"count": 0, "mu": mu, "nu": zeros}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor],
             state: OptState) -> Tuple[OptState, torch.Tensor]:
        """One update of every parameter in place; returns the new state
        (its moment tensors are updated in place too) and the unclipped
        gradients' global norm. On the card, whatever the number of
        tensors: K5's norm, then K5's update (two launches); or K11, which
        computes the norm from the sums its moments take (one call)."""
        cfg = self.cfg
        count = state["count"]
        lr = self.schedule(count)            # optax: before the increment
        names = list(params)
        g = [grads[n] for n in names]
        if cfg.optimizer == "adafactor":
            hyper = adafactor.Hyper(max_norm=cfg.grad_clip_norm, count=count,
                                    lr=lr, weight_decay=cfg.weight_decay)
            with record_function("optimizer"):
                norm = adafactor.update(params, {n: grads[n] for n in names},
                                        state, self._leaves(params), hyper)
            return {**state, "count": count + 1}, norm
        with record_function("grad_norm"):
            norm = fused.global_norm(g)
        if cfg.optimizer == "adamw":
            t = torch.tensor(count + 1, dtype=torch.float32)
            bc1 = float(1 - torch.tensor(cfg.b1, dtype=torch.float32) ** t)
            bc2 = float(1 - torch.tensor(cfg.b2, dtype=torch.float32) ** t)
        else:
            bc1 = bc2 = 1.0
        hyper = fused.Hyper(max_norm=cfg.grad_clip_norm, b1=cfg.b1,
                            b2=cfg.b2, bc1=bc1, bc2=bc2,
                            weight_decay=cfg.weight_decay, lr=lr)
        moments = state["trace" if cfg.optimizer == "sgd" else "mu"]
        with record_function("optimizer"):
            fused.update(cfg.optimizer, [params[n] for n in names], g,
                         [moments[n] for n in names],
                         [state["nu"][n] for n in names]
                         if cfg.optimizer == "adamw" else None,
                         norm, hyper)
        return {**state, "count": count + 1}, norm


@dataclasses.dataclass
class TrainState:
    """step: updates applied so far; params: the model's own parameters by
    state-dict name (updated in place); opt_state: the optimizer's;
    extra_vars: the model's non-parameter state by buffer name (an image
    model's BatchNorm running statistics; the JAX ``extra_vars``), empty
    for LMs, updated in place by the training forward."""
    step: int
    params: Dict[str, torch.Tensor]
    opt_state: OptState
    extra_vars: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)


class Trainer:
    """Owns one model's train and eval steps on one device."""

    def __init__(self, model: torch.nn.Module, train_cfg: TrainConfig,
                 device: DeviceLike = None):
        if train_cfg.task not in ("lm", "image"):
            raise ValueError(f"unknown task {train_cfg.task!r} (lm | image)")
        model_cfg = getattr(model, "cfg", None)
        if train_cfg.task == "image":
            if train_cfg.optimizer == "adafactor":
                raise NotImplementedError(
                    "adafactor on an image model: models/layout.py::"
                    "jax_leaves describes the LM leaves only, and optax "
                    "factors a JAX [E, H, Dh] kernel otherwise than the "
                    "port's [H*Dh, E] (ROADMAP Queue 1 item 6e)")
            if getattr(model_cfg, "dropout", 0.0) > 0:
                raise ValueError(
                    "dropout > 0: the JAX trainer passes no dropout rng, so "
                    "flax refuses the step; train with dropout=0")
        if getattr(model_cfg, "router_jitter", 0.0) > 0:
            raise NotImplementedError(
                "router jitter (router_jitter > 0) is not ported yet "
                "(ROADMAP Queue 1 item 6c, open for jitter alone)")
        if train_cfg.attn_impl not in _ONE_DEVICE_ATTN:
            raise ValueError(f"unknown attn_impl {train_cfg.attn_impl!r} "
                             f"({' | '.join(_ONE_DEVICE_ATTN)})")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = train_cfg
        self.attn_impl = _ONE_DEVICE_ATTN[train_cfg.attn_impl]
        # The MoE aux weight: the TrainConfig's, else the model config's
        # (the JAX trainer's rule, so a default TrainConfig keeps it).
        self.aux_loss_weight = train_cfg.aux_loss_weight or float(
            getattr(model_cfg, "aux_loss_weight", 0.0) or 0.0)
        # adafactor factors and blocks by the JAX leaves of the model.
        self.optimizer = train_cfg.make_optimizer(
            jax_leaves(model_cfg) if train_cfg.optimizer == "adafactor"
            and model_cfg is not None else None)

    # ---------------- init ----------------

    def init_state(self, seed: int = 0) -> TrainState:
        """Initialise the model's weights from ``seed`` on the device (the
        JAX initialisers; the numbers differ from JAX's) and a fresh
        optimizer state."""
        self.model.init_weights(
            torch.Generator(device=self.device).manual_seed(seed))
        params = dict(self.model.named_parameters())
        n = sum(p.numel() for p in params.values())
        log.info("initialised model", kv={"params": f"{n / 1e6:.1f}M"})
        extra = (dict(self.model.named_buffers())
                 if self.cfg.task == "image" else {})
        return TrainState(step=0, params=params,
                          opt_state=self.optimizer.init(params),
                          extra_vars=extra)

    # ---------------- step ----------------

    def _lm_head_kernel(self) -> torch.Tensor:
        m = self.model
        return m.embed if m.cfg.tie_embeddings else m.lm_head.weight

    def _lm_ce(self, batch: Dict[str, torch.Tensor], *,
               z_loss_weight: float, with_aux: bool = False):
        """LM forward + cross-entropy shared by the train loss and eval:
        (loss, accuracy, aux). aux: with ``with_aux``, the MoE layers' mean
        aux loss (``Llama.forward(return_aux=True)``), else None."""
        tokens = batch["inputs"].to(self.device)
        inputs, labels = tokens[:, :-1], tokens[:, 1:].long()
        mask = batch.get("mask")
        if mask is not None:
            mask = mask.to(self.device)[:, 1:]
        chunked = self.cfg.loss_chunk > 0
        with record_function("forward"):
            out = self.model(inputs, return_hidden=chunked,
                             attn_impl=self.attn_impl, return_aux=with_aux)
        out, aux = out if with_aux else (out, None)
        with record_function("loss"):
            if chunked:
                B, S, E = out.shape
                loss, count, hits = chunked_cross_entropy(
                    out.reshape(B * S, E), self._lm_head_kernel(),
                    labels.reshape(B * S),
                    mask=None if mask is None else mask.reshape(B * S),
                    z_loss_weight=z_loss_weight, block=self.cfg.loss_chunk)
            else:
                loss, count, hits = cross_entropy_stats(
                    out, labels, mask=mask, z_loss_weight=z_loss_weight)
        return loss, hits / count, aux

    def _image_ce(self, batch: Dict[str, torch.Tensor], *, train: bool):
        """Image forward + cross-entropy (no z-loss) shared by the train
        loss and eval: (loss, accuracy, None). ``train``: batch statistics,
        the running ones updated; else the running ones."""
        images = batch["inputs"].to(self.device, non_blocking=True)
        labels = batch["labels"].to(self.device).long()
        with record_function("forward"):
            logits = self.model(images, train=train)
        with record_function("loss"):
            loss, count, hits = cross_entropy_stats(logits, labels)
        return loss, hits / count, None

    def _grads(self, params: Dict[str, torch.Tensor], batch):
        """(loss, accuracy, aux, grads). As the JAX trainer's ``_loss_lm``:
        with a positive aux weight the loss gains weight x the layers' mean
        aux loss, which is reported (0 without one); ``_loss_image``: the
        classifier's cross-entropy."""
        if self.cfg.task == "image":
            loss, accuracy, aux = self._image_ce(batch, train=True)
        else:
            loss, accuracy, aux = self._lm_ce(
                batch, z_loss_weight=self.cfg.z_loss_weight,
                with_aux=self.aux_loss_weight > 0)
        if aux is None:
            aux = torch.zeros((), device=self.device)
        else:
            loss = loss + self.aux_loss_weight * aux
        with record_function("backward"):
            grads = torch.autograd.grad(loss, list(params.values()))
        # cuDNN returns a convolution's weight gradient channels-last; the
        # optimizer reads every gradient in its parameter's contiguous
        # layout (a no-op for the rest).
        grads = [g.contiguous() for g in grads]
        return loss.detach(), accuracy, aux.detach(), dict(zip(params, grads))

    def _token_weight(self, mb: Dict[str, torch.Tensor]) -> torch.Tensor:
        """A microbatch's weight: its valid tokens, or (image) its rows."""
        x = mb["inputs"]
        if self.cfg.task == "image":
            return torch.tensor(float(x.shape[0]), device=self.device)
        if mb.get("mask") is not None:
            return mb["mask"][:, 1:].to(self.device).float().sum()
        return torch.tensor(float(x.shape[0] * (x.shape[1] - 1)),
                            device=self.device)

    def step(self, state: TrainState,
             batch: Dict[str, torch.Tensor]) -> Tuple[TrainState, Dict]:
        """One optimizer update. Metrics (loss, grad_norm, accuracy,
        aux_loss) stay device tensors: reading one is the caller's sync."""
        K = self.cfg.grad_accum_steps
        params = state.params
        if K <= 1:
            loss, accuracy, aux, grads = self._grads(params, batch)
        else:
            # Microbatches one after another; grads accumulate in f32,
            # each microbatch (and its metrics) weighted by its count of
            # valid tokens (image: rows), so the result is the full batch's
            # masked mean; a BatchNorm's running statistics thread through
            # the microbatches in order.
            n = batch["inputs"].shape[0]
            if n % K:
                raise ValueError(f"batch dim {n} not divisible by "
                                 f"grad_accum_steps {K}")
            acc = {name: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                   for name, p in params.items()}
            wsum = loss = accuracy = aux = torch.zeros((), device=self.device)
            for i in range(K):
                mb = {k: v[i * n // K:(i + 1) * n // K]
                      for k, v in batch.items()}
                mb_loss, mb_acc, mb_aux, g = self._grads(params, mb)
                w = self._token_weight(mb)
                for name, gi in g.items():
                    acc[name].add_(w * gi.float())
                wsum, loss = wsum + w, loss + w * mb_loss
                accuracy = accuracy + w * mb_acc
                aux = aux + w * mb_aux
            wsum = wsum.clamp_min(1e-9)
            grads = {name: a.div_(wsum) for name, a in acc.items()}
            loss, accuracy, aux = loss / wsum, accuracy / wsum, aux / wsum
        opt_state, grad_norm = self.optimizer.step(params, grads,
                                                   state.opt_state)
        metrics = {"loss": loss, "grad_norm": grad_norm,
                   "accuracy": accuracy, "aux_loss": aux}
        return TrainState(step=state.step + 1, params=params,
                          opt_state=opt_state,
                          extra_vars=state.extra_vars), metrics

    # ---------------- eval ----------------

    @torch.no_grad()
    def eval_step(self, state: TrainState,
                  batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Cross-entropy without z-loss or the aux term (optimisation
        terms, not model quality) and accuracy; nothing is updated (an
        image model normalises with its running statistics)."""
        if self.cfg.task == "image":
            loss, accuracy, _ = self._image_ce(batch, train=False)
        else:
            loss, accuracy, _ = self._lm_ce(batch, z_loss_weight=0.0)
        return {"loss": loss, "accuracy": accuracy}

    def evaluate(self, state: TrainState,
                 batches: Iterable[Dict[str, Any]]) -> Dict[str, float]:
        """Mean metrics over host batches (numpy or tensors), plus
        perplexity for the LM task."""
        sums: Dict[str, float] = {}
        n = 0
        for b in batches:
            m = self.eval_step(state, {k: torch.as_tensor(v)
                                       for k, v in b.items()})
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        if n == 0:
            return {}
        out = {k: v / n for k, v in sums.items()}
        if self.cfg.task == "lm":
            out["perplexity"] = math.exp(min(out["loss"], 30.0))
        return out

