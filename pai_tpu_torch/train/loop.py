"""The training engine of the port, counterpart of ``pai_tpu/train/loop.py``:
epoch loop, validation cadence, metric logging, best/last checkpoints.

* epochs / max-steps limits, validation every ``val_epochs`` epochs, CSV
  metric rows every 10 steps (the only points where the loop waits for the
  device); the GAN families run the lean step (no train metrics) on the
  other nine; on a terminal a live line redrawn every step (``_Progress``),
  elsewhere one line per log row;
* validation: the GAN families run the evaluation step on each batch;
  Palette samples each batch with the 100-step chain and writes the outputs
  as PNGs under ``<log_dir>/<name>/version_<k>/<epoch + 1>/``. Both reduce
  the per-image metrics as Lightning does: ``val_ssim`` the per-image mean,
  ``val_psnr``/``val_rmse`` batch-size-weighted means of the batch values
  computed from the batch's mean MSE;
* ``best`` on the largest ``val_ssim``, ``last`` at every validation and at
  the end; a non-finite loss writes the ``diverged`` slot and halts;
  ``--resume`` continues from ``last`` at the next epoch;
* EMA updated after every step; validation and checkpoints' evaluation
  weights are the EMA's.

Every generator family trains: the seven GAN families (the five losses, with
the PatchGAN for ``gan``) and Palette. ``--scan-steps K`` (1, 2, 5 or 10)
chunks the steps as the JAX package does (``pai_tpu/train/loop.py:495-517``):
from a K-aligned step where the budget leaves room, K-1 lean steps in one
dispatch (``steps.TrainScan``: on the card one replay of a CUDA graph, the
counterpart of the JAX package's ``lax.scan``), then one ordinary step, on
which every log row falls; the epoch's remainder runs ordinary steps, and no
chunk runs while the profiler traces. The result is that of K ordinary steps.
On the CPU and under a mesh the chunk's lean steps are ordinary steps.
``--profile-dir`` writes a ``torch.profiler`` trace of the first 12 steps
there.

Multi-device (``pai_tpu/train/loop.py:122-170``): one process per rank,
started by a launcher (``torchrun --nproc-per-node N``; or a process group the
caller made). The mesh is ``('dp', 'tp'[, 'sp'])`` with ``tp`` and ``sp``
from ``--tp``/``--sp`` and ``dp = gcd(batch_size, world / (tp * sp))``; a
world that ``tp * sp`` does not divide, or that dp does not then fill,
raises the JAX package's ``ValueError`` before anything is written. Each dp
index loads and trains on its rows of every global batch; ``--tp`` splits
the large convolution kernels on their output channels, ``--sp`` runs the
UNet's attention as ring attention, ``--fsdp`` shards both networks with
FSDP2 over dp (a dp of one replicates, as the JAX rule does). The mesh is
installed in ``parallel.context`` for the length of ``fit``. Validation
gathers every rank's per-image values in rank order. IO is rank zero's:
CSV, hparams, PNGs and prints; checkpoint saves are collective (every rank
gathers the full state, rank zero writes it), so a slot is the same whatever
the mix, and resumes under any other.
"""

from __future__ import annotations

import math
import os
import sys
import time
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from pai_tpu_torch.config import (TRAIN_DEFAULTS, apply_precision_policy,
                                  compute_dtype, resolve_device,
                                  sanitize_hparams)
from pai_tpu_torch.data import BatchLoader, ImageDataset
from pai_tpu_torch.diffusion import make_schedule
from pai_tpu_torch.models import Discriminator
from pai_tpu_torch.parallel.context import set_mesh_context
from pai_tpu_torch.parallel.distributed import (all_gather_cat,
                                                launcher_world,
                                                maybe_initialize_distributed)
from pai_tpu_torch.parallel.mesh import (axis_group, axis_rank, axis_size,
                                         make_mesh)
from pai_tpu_torch.parallel.partitioning import (TpShard, full_tensor,
                                                 local_share, reshard,
                                                 shard_state, tp_layouts)
from pai_tpu_torch.restore import build_generator_from_hparams
from pai_tpu_torch.train import steps as steps_lib
from pai_tpu_torch.train.state import GanTrainState, PaletteTrainState
from pai_tpu_torch.utils.checkpoint import (DISCRIMINATOR_PREFIX, EMA_PREFIX,
                                            OPT_PREFIX, CheckpointManager)
from pai_tpu_torch.utils.images import denormalize, to_int, write_png
from pai_tpu_torch.utils.logging import CSVLogger

IMAGE_SIZE = 256
LOG_EVERY = 10
PROFILE_STEPS = 12

TrainState = Union[GanTrainState, PaletteTrainState]


class _Progress:
    """The live progress line, counterpart of ``pai_tpu/train/loop.py:50-104``.
    Where ``sys.stderr`` is a TTY: an inline ``\\r`` line redrawn every step
    (at most every ``_MIN_INTERVAL`` seconds) with the step and the last
    metric values; the loss refreshes at most every ``_FETCH_INTERVAL``
    seconds from the previous lean step's metrics, the other values at each
    log row. Elsewhere: a plain line at each log row only.

    The host never waits for the line: ``stage`` copies a lean step's
    metrics into pinned host memory behind the step (``non_blocking``) and
    records an event, and ``fetch`` reads them only once that event has
    completed, else the values shown stay. A synchronous read of the
    previous step's loss would queue behind the step just launched and
    drain the queue. On the CPU the values are read as they are."""

    _MIN_INTERVAL = 0.05   # seconds between inline redraws
    _FETCH_INTERVAL = 0.5  # seconds between off-row loss fetches

    def __init__(self):
        self._open = False
        self._tty = sys.stderr.isatty()
        self._last_draw = 0.0
        self._last_fetch = 0.0
        self._staged = None   # (names, host values, event or None)
        self._host = None     # pinned buffer of the staged values
        self.values: Dict[str, float] = {}

    @property
    def live(self) -> bool:
        """Whether the off-row steps are shown."""
        return self._tty

    def logged(self, values: Mapping[str, float]) -> None:
        """A log row's values, fetched by the loop: they replace all."""
        self.values = dict(values)
        self._staged = None

    def stage(self, metrics: Mapping[str, torch.Tensor]) -> None:
        """Start the copy of a lean step's metrics to the host."""
        names = tuple(metrics)
        stacked = torch.stack([metrics[k].detach().float().reshape(())
                               for k in names])
        if stacked.device.type != "cuda":
            self._staged = (names, stacked, None)
            return
        if self._host is None:  # a lean step's metrics keep their names
            self._host = torch.empty(len(names), dtype=torch.float32,
                                     pin_memory=True)
        self._host.copy_(stacked, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._staged = (names, self._host, event)

    def fetch(self) -> None:
        """At most every ``_FETCH_INTERVAL``: the staged values, where the
        copy has completed."""
        now = time.time()
        if self._staged is None or now - self._last_fetch < \
                self._FETCH_INTERVAL:
            return
        names, host, event = self._staged
        if event is not None and not event.query():
            return
        self._last_fetch = now
        self.values.update(zip(names, host.tolist()))
        self._staged = None

    def update(self, msg: str, throttle: bool = False) -> None:
        if self._tty:
            now = time.time()
            if throttle and now - self._last_draw < self._MIN_INTERVAL:
                return
            self._last_draw = now
            # \x1b[K clears the tail of a longer previous line
            print("\r[pai_tpu_torch] " + msg + "\x1b[K", end="",
                  file=sys.stderr, flush=True)
            self._open = True
        elif not throttle:
            print("[pai_tpu_torch] " + msg, file=sys.stderr, flush=True)

    def close(self) -> None:
        """End an open inline line before other output takes the terminal."""
        if self._open:
            print(file=sys.stderr, flush=True)
            self._open = False


def _networks(state: TrainState
              ) -> List[Tuple[str, torch.nn.Module, torch.optim.Optimizer]]:
    """(slot-name prefix, module, its optimizer) of every network a train
    state trains."""
    if isinstance(state, PaletteTrainState):
        return [("", state.model, state.opt)]
    nets = [("", state.generator, state.g_opt)]
    if state.discriminator is not None:
        nets.append((DISCRIMINATOR_PREFIX, state.discriminator, state.d_opt))
    return nets


def train_state_dict(state: TrainState) -> Dict[str, torch.Tensor]:
    """The whole train state as one flat ``state_dict``: each module's
    tensors (parameters and running statistics; a discriminator's under
    ``discriminator.``), ``ema.<name>`` shadow weights and
    ``opt.<name>.<key>`` Adam state. The tensors are the live ones, not
    copies."""
    flat: Dict[str, torch.Tensor] = {}
    for prefix, module, opt in _networks(state):
        flat.update({prefix + k: v for k, v in module.state_dict().items()})
        for name, param in module.named_parameters():
            for key, value in opt.state.get(param, {}).items():
                flat[f"{OPT_PREFIX}{prefix}{name}.{key}"] = value
    if state.ema is not None:
        flat.update({EMA_PREFIX + k: v for k, v in state.ema.params.items()})
    return flat


def _tp_layouts(state: TrainState) -> Dict[str, TpShard]:
    """``{parameter slot name: TpShard}`` of the kernels tp split."""
    layouts: Dict[str, TpShard] = {}
    for prefix, module, _ in _networks(state):
        layouts.update(tp_layouts(module, prefix))
    return layouts


def _layout_of(key: str, layouts: Mapping[str, TpShard]) -> Optional[TpShard]:
    """The split of the parameter a slot entry belongs to (its EMA shadow and
    Adam moments are split as it is)."""
    if key.startswith(EMA_PREFIX):
        key = key[len(EMA_PREFIX):]
    elif key.startswith(OPT_PREFIX):
        key = key[len(OPT_PREFIX):].rsplit(".", 1)[0]
    return layouts.get(key)


def full_train_state_dict(state: TrainState) -> Dict[str, torch.Tensor]:
    """``train_state_dict`` with every tensor whole: FSDP shares and tp
    shares gathered. Collective on a mesh: every rank calls it."""
    for _, module, _ in _networks(state):
        reshard(module)
    layouts = _tp_layouts(state)
    return {k: full_tensor(v, _layout_of(k, layouts))
            for k, v in train_state_dict(state).items()}


def load_train_state(state: TrainState, flat: Mapping[str, torch.Tensor],
                     meta: Mapping) -> None:
    """Restore ``state`` in place from a training slot written from
    ``train_state_dict`` (and its meta). The slot's tensors are whole; each
    goes in as this rank's share where the state is split (tp, FSDP)."""
    layouts = _tp_layouts(state)

    def share(key, live):
        return local_share(flat[key], live, _layout_of(key, layouts))

    for prefix, module, opt in _networks(state):
        reshard(module)
        module.load_state_dict({k: share(prefix + k, v)
                                for k, v in module.state_dict().items()})
        opt_sd = opt.state_dict()
        for index, (name, param) in enumerate(module.named_parameters()):
            head = f"{OPT_PREFIX}{prefix}{name}."
            entry = {k[len(head):]: v if k.endswith(".step")
                     else share(k, param)
                     for k, v in flat.items() if k.startswith(head)}
            if entry:
                opt_sd["state"][index] = entry
        opt.load_state_dict(opt_sd)
    if state.ema is not None:
        with torch.no_grad():
            for k, v in state.ema.params.items():
                v.copy_(share(EMA_PREFIX + k, v))
        state.ema.num_updates = int(meta.get("ema_num_updates", 0))
    state.step = int(meta["step"])


class Trainer:
    """One training run of a generator family; ``hparams`` as the train CLI
    gives them (any missing key takes ``TRAIN_DEFAULTS``'s value), plus
    ``name``, ``data``, ``val_data`` and ``device``."""

    def __init__(self, hparams: Mapping, image_size: Optional[int] = None):
        h = dict(TRAIN_DEFAULTS, **hparams)
        scan_k = int(h.get("scan_steps") or 1)
        if scan_k < 1 or LOG_EVERY % scan_k:
            raise ValueError("--scan-steps must divide the 10-step log "
                             "cadence (1, 2, 5 or 10)")
        self.image_size = int(image_size or h.get("image_size") or IMAGE_SIZE)
        # the slots' hparams rebuild the model at the size it trained at
        # (TransUNet's positional embedding depends on it)
        h["image_size"] = self.image_size
        self.hparams = h
        self.name = h["name"]
        self._init_mesh(h)
        self.seed = int(h.get("seed") or 0)
        self.is_palette = h["model"] == "palette"
        self.learn_var = bool(h.get("learn_variance", False))
        apply_precision_policy(h["precision"])

        # seeds the weights' init and then every step's draws
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.seed)
        self.model = build_generator_from_hparams(
            h, self.image_size, generator=self.generator, device=self.device)
        self.discriminator: Optional[torch.nn.Module] = None
        if self.is_palette:
            self.sched_train = make_schedule(h["schedule_type"], 2000, 1e-6,
                                             0.01, device=self.device)
            self.sched_inf = make_schedule("cosine", 100, device=self.device)
            self.sample_step = steps_lib.make_palette_sample_step(
                self.model, self.sched_inf, self.learn_var)
        else:
            if h["loss_type"] == "gan":
                self.discriminator = Discriminator(
                    int(h.get("in_channels") or 1)
                    + int(h.get("out_channels") or 1),
                    dtype=compute_dtype(h["precision"]),
                    generator=self.generator, device=self.device)
            self.eval_step = steps_lib.make_gan_eval_step(self.model)
        # rank zero's IO: the other ranks keep no logger
        self.logger = CSVLogger(h.get("log_dir") or "logs", self.name) \
            if self.is_main else None
        if self.is_main:
            self.logger.log_hparams(sanitize_hparams(h))
        self.ckpt = CheckpointManager(h.get("ckpt_dir") or "checkpoints",
                                      self.name, writer=self.is_main)
        self.val_loader: Optional[BatchLoader] = None

    def _init_mesh(self, h: Mapping) -> None:
        """The process group, this rank's device and the mesh, with the JAX
        package's errors (``pai_tpu/train/loop.py:142-159``)."""
        device = resolve_device(h.get("device") or "cuda")
        launched = "WORLD_SIZE" in os.environ or dist.is_initialized()
        if device.type == "cuda" and device.index is None and launched:
            # one card per rank where the host has them (ranks beyond the
            # card count share: the gloo backend carries that)
            local = launcher_world()[2]
            device = torch.device("cuda", local % torch.cuda.device_count())
        if device.type == "cuda" and launched:
            torch.cuda.set_device(device)
        self.rank, self.world = maybe_initialize_distributed(device)
        self.device = device
        self.is_main = self.rank == 0
        self.tp = int(h.get("tp") or 1)
        self.sp = int(h.get("sp") or 1)
        self.fsdp = bool(h.get("fsdp"))
        if self.world % (self.tp * self.sp):
            raise ValueError(
                f"--tp {self.tp} x --sp {self.sp} does not divide "
                f"{self.world} devices")
        dp = math.gcd(int(h["batch_size"]), self.world // (self.tp * self.sp))
        if self.world > 1 and dp * self.tp * self.sp != self.world:
            raise ValueError(
                f"multi-process run: batch_size {h['batch_size']} x tp "
                f"{self.tp} x sp {self.sp} yields dp={dp}, which does not "
                f"span all {self.world} devices; choose a batch size "
                f"divisible by {self.world // (self.tp * self.sp)}")
        self.mesh = make_mesh(self.world, self.tp, self.sp, device.type) \
            if dist.is_initialized() else None
        self.dp = axis_size(self.mesh, "dp")
        self.dp_rank = axis_rank(self.mesh, "dp")

    def _gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every dp rank's rows of ``x``, in rank order (collective)."""
        if self.dp == 1:
            return x
        return all_gather_cat(x, axis_group(self.mesh, "dp"))

    # ------------------------------------------------------------------
    def _slot(self, state: TrainState) -> tuple:
        """What a checkpoint slot holds besides the hparams: the flat train
        state (whole tensors: collective on a mesh) and the EMA's update
        count (its decay ramp)."""
        flat = train_state_dict(state) if self.mesh is None \
            else full_train_state_dict(state)
        return (flat, {"ema_num_updates": state.ema.num_updates
                       if state.ema is not None else 0})

    def validate(self, state: TrainState, epoch: int) -> Dict[str, float]:
        """Evaluate every validation batch (Palette: sample it and write its
        outputs) and reduce the per-image metrics (see the module
        docstring)."""
        if self.is_palette:
            params = steps_lib.palette_eval_params(state)
            if self.is_main:
                epoch_dir = os.path.join(self.logger.log_dir, str(epoch + 1))
                os.makedirs(epoch_dir, exist_ok=True)
            generator = torch.Generator(device=self.device).manual_seed(
                self.seed + 7919 + epoch)
        else:
            params = steps_lib.gan_eval_params(state)
        ssim_sum = psnr_wsum = rmse_wsum = 0.0
        total = out_index = 0
        for batch in self.val_loader:
            n = batch.n_valid
            if self.is_palette:
                y_pred, per_image = self.sample_step(params, batch.x,
                                                     batch.y, generator)
                y_pred = self._gather_rows(y_pred)
                if self.is_main:
                    frames = to_int(denormalize(y_pred[:n])).cpu().numpy()
                    for frame in frames:
                        write_png(frame, os.path.join(
                            epoch_dir, f"output_{out_index}.png"))
                        out_index += 1
            else:
                _, per_image = self.eval_step(params, batch.x, batch.y)
            per_image = {k: self._gather_rows(v)
                         for k, v in per_image.items()}
            ssim_sum += float(per_image["ssim"][:n].sum())
            batch_mse = float(per_image["mse"][:n].mean())
            psnr_wsum += n * 10.0 * math.log10(1.0 / max(batch_mse, 1e-20))
            rmse_wsum += n * math.sqrt(batch_mse)
            total += n
        if total == 0:
            return {}
        return {"val_ssim": ssim_sum / total, "val_psnr": psnr_wsum / total,
                "val_rmse": rmse_wsum / total}

    def _steps(self, n_train: int):
        """``(state, train_step, lean_step)``: a fresh train state (its
        networks placed on the mesh first, so that the optimizers hold the
        placed parameters) and the step of the logged steps and of the
        others."""
        h = self.hparams
        if self.mesh is not None:
            shard_state([self.model, self.discriminator], self.mesh, self.tp,
                        self.fsdp)
        if self.is_palette:
            step = steps_lib.make_palette_train_step(
                self.model, self.sched_train, self.learn_var,
                warmup_steps_per_epoch=self._warmup_unit(n_train),
                generator=self.generator,
                seed=self.seed)
            state = steps_lib.init_palette_state(self.model, bool(h["ema"]))
            return state, step, step
        state = steps_lib.init_gan_state(self.model, self.discriminator,
                                         h["loss_type"], bool(h["ema"]))
        step, lean = (steps_lib.make_gan_train_step(
            self.model, self.discriminator, h["loss_type"],
            compute_metrics=full, rng=self.generator, seed=self.seed)
            for full in (True, False))
        return state, step, lean

    def _scan(self, n_train: int) -> steps_lib.TrainScan:
        """The lean steps of a ``--scan-steps`` chunk in one dispatch."""
        h = self.hparams
        if self.is_palette:
            return steps_lib.make_palette_train_scan(
                self.model, self.sched_train, self.learn_var,
                warmup_steps_per_epoch=self._warmup_unit(n_train),
                generator=self.generator, seed=self.seed)
        return steps_lib.make_gan_train_scan(
            self.model, self.discriminator, h["loss_type"],
            rng=self.generator, seed=self.seed)

    def _warmup_unit(self, n_train: int) -> Optional[int]:
        """Steps per epoch where Palette's warmup advances per epoch."""
        h = self.hparams
        return math.ceil(n_train / int(h["batch_size"])) \
            if h.get("warmup_unit", "epoch") == "epoch" else None

    # ------------------------------------------------------------------
    def fit(self) -> Dict[str, float]:
        set_mesh_context(self.mesh, "sp" if self.sp > 1 else None)
        try:
            return self._fit()
        finally:
            # later work in this thread (the API's predict, a report) must
            # not dispatch through a stale mesh
            set_mesh_context(None)

    def _fit(self) -> Dict[str, float]:
        h = self.hparams
        bs = int(h["batch_size"])
        train_dataset = ImageDataset(h["data"], self.image_size)
        state, train_step, lean_step = self._steps(len(train_dataset))
        self.train_scan = self._scan(len(train_dataset)) \
            if int(h.get("scan_steps") or 1) > 1 else None
        val_dataset = ImageDataset(h["val_data"], self.image_size) \
            if h.get("val_data") else None
        rows = dict(process_index=self.dp_rank, process_count=self.dp,
                    device=self.device)
        self.val_loader = BatchLoader(val_dataset, bs, shuffle=False,
                                      pad_mode="zero", **rows) \
            if val_dataset else None
        loader = BatchLoader(train_dataset, bs, shuffle=True,
                             pad_mode="cycle", seed=self.seed, **rows)

        start_epoch = 0
        if h.get("resume"):
            try:
                flat, meta = self.ckpt.restore("last")
            except FileNotFoundError:
                pass
            else:
                load_train_state(state, flat, meta)
                start_epoch = meta["epoch"] + 1
                if self.is_main:
                    print(f"[pai_tpu_torch] resumed from epoch "
                          f"{meta['epoch']} (step {meta['step']})",
                          flush=True)

        profiler = None
        if h.get("profile_dir") and self.is_main:
            profiler = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]
                + ([torch.profiler.ProfilerActivity.CUDA]
                   if self.device.type == "cuda" else []))
            profiler.start()

        max_steps = int(h["steps"])
        scan_k = int(h.get("scan_steps") or 1)
        progress = _Progress()
        last_val: Dict[str, float] = {}
        images_seen = 0
        done = False
        # the same on every rank (only rank zero traces): the ranks must
        # chunk alike
        profiling = bool(h.get("profile_dir"))
        t0 = time.time()

        def process_single(state, batch, epoch):
            """One optimizer step and its logging, divergence, profiler and
            budget bookkeeping; returns whether the step budget is spent."""
            nonlocal images_seen, profiler, profiling
            step = train_step if (state.step + 1) % LOG_EVERY == 0 \
                else lean_step
            state, step_metrics = step(state, batch.x, batch.y)
            images_seen += batch.n_valid
            if state.step % LOG_EVERY == 0:
                # the loop's one wait for the device
                vals = {k: float(v) for k, v in step_metrics.items()}
                if self.is_main:
                    self.logger.log_metrics(vals, state.step, epoch)
                    rate = images_seen / max(time.time() - t0, 1e-9)
                    progress.logged(vals)
                    progress.update(
                        f"epoch {epoch + 1} step {state.step} "
                        + " ".join(f"{k}={v:.4f}" for k, v in vals.items())
                        + f" | {rate:.1f} img/s")
                if not np.isfinite(vals["loss"]):
                    flat, extra = self._slot(state)
                    self.ckpt.save_diverged(flat, h, state.step, epoch,
                                            **extra)
                    raise FloatingPointError(
                        f"non-finite loss at step {state.step} (diverged "
                        "state saved for postmortem; --resume recovers from "
                        "the last checkpoint)")
            elif self.is_main and progress.live:
                # the previous step's values where they have arrived, then
                # this step's copy started
                progress.fetch()
                progress.stage(step_metrics)
                progress.update(
                    f"epoch {epoch + 1} step {state.step} "
                    + " ".join(f"{k}={v:.4f}"
                               for k, v in progress.values.items()),
                    throttle=True)
            if profiling and state.step >= PROFILE_STEPS:
                profiling = False
                if profiler is not None:
                    self._stop_profiler(profiler)
                    profiler = None
            return max_steps > 0 and state.step >= max_steps

        epoch = start_epoch - 1  # resume may already satisfy the budget
        try:
            for epoch in range(start_epoch, int(h["epochs"])):
                loader.epoch = epoch  # the epoch's seeded order
                pending = []
                for batch in loader:
                    # --scan-steps K (pai_tpu/train/loop.py:495-517): K-1
                    # lean steps in one dispatch, then one ordinary step,
                    # which a log row always falls on; chunks start only at
                    # K-aligned steps where the budget leaves room, and not
                    # while the profiler traces
                    if (scan_k > 1 and not profiling
                            and state.step % scan_k == 0
                            and (max_steps <= 0
                                 or state.step + scan_k <= max_steps)):
                        pending.append(batch)
                        if len(pending) < scan_k:
                            continue
                        head, last = pending[:-1], pending[-1]
                        pending = []
                        state, _ = self.train_scan(
                            state, [b.x for b in head], [b.y for b in head])
                        images_seen += sum(b.n_valid for b in head)
                        done = process_single(state, last, epoch)
                    else:
                        done = process_single(state, batch, epoch)
                    if done:
                        break
                for batch in pending:  # the epoch's remainder: plain steps
                    done = process_single(state, batch, epoch)
                    if done:
                        break

                if (epoch + 1) % int(h["val_epochs"]) == 0 \
                        and self.val_loader is not None:
                    progress.close()
                    last_val = self.validate(state, epoch)
                    if last_val and self.is_main:
                        self.logger.log_metrics(last_val, state.step, epoch)
                        print(f"[pai_tpu_torch] epoch {epoch + 1} step "
                              f"{state.step}: " + " ".join(
                                  f"{k}={v:.4f}" for k, v in last_val.items()),
                              flush=True)
                    if last_val:
                        # collective: every rank gathers, rank zero writes;
                        # the metrics are the same on every rank, and so is
                        # the best-slot decision
                        flat, extra = self._slot(state)
                        ssim = last_val["val_ssim"]
                        self.ckpt.maybe_save_best(flat, h, state.step, epoch,
                                                  ssim, **extra)
                        self.ckpt.save_last(flat, h, state.step, epoch, ssim,
                                            **extra)
                if done:
                    break
        finally:
            progress.close()
            if profiler is not None:
                self._stop_profiler(profiler)

        flat, extra = self._slot(state)
        self.ckpt.save_last(flat, h, state.step, epoch,
                            last_val.get("val_ssim"), **extra)
        if self.world > 1:
            dist.barrier()  # the slots are whole before any rank reads them
        wall = time.time() - t0
        return {"steps": state.step,
                "images_per_sec": images_seen / wall if wall > 0 else 0.0,
                **last_val}

    def _stop_profiler(self, profiler) -> None:
        profiler.stop()
        os.makedirs(self.hparams["profile_dir"], exist_ok=True)
        path = os.path.join(self.hparams["profile_dir"], "trace.json")
        profiler.export_chrome_trace(path)
        print(f"[pai_tpu_torch] profile written to {path}", flush=True)


def fit(hparams: Mapping) -> Dict[str, float]:
    return Trainer(hparams).fit()
