"""Staged FLAME tracking: sequential warm-started fitting + global refinement.

Counterpart of vhap_tpu/tracker/tracker.py (reference: GlobalTracker,
vhap/model/tracker.py:1221-1529): the reference's stage schedule
(lmk_init_rigid -> ... -> rgb_global_tracking), warm-start copy-forward,
per-epoch lr decay (0.9 ** epoch) and lr_scale 0.1 in the global phase,
npz checkpoints in the reference schema, a resumable run state, scalar logs
and a bounded background media writer.

On the device:
  * one train step per (stage, lr_scale), built once from make_energy_fn
    and make_train_step and reused across batches and epochs; Adam's state
    is re-initialised from the current parameters at every stage;
  * on a card, alone or in an NCCL group, the step's second call captures
    it as CUDA graphs and later calls replay them (tracker/step_graph.py,
    every rank alike; a gloo group's steps stay eager): the
    step then returns the graphs' own parameter and Adam buffers, which the
    call after next overwrites (no call writes the tensors it is given), and
    an energy and log that the next call may overwrite (read at once), and
    one step's graphs live at a time (summary()["step_graph"] counts the
    calls run eager, captured and replayed, and summary()["collectives"]
    the last eager or captured step's collectives by caller); elsewhere the
    eager step returns a new parameter dict;
  * a prefetch thread decodes frames into pinned host batches; the main
    thread copies them to the card without blocking;
  * the loop never reads a device scalar per step: train scalars are read
    every `log.interval_scalar` steps, and the evaluation and media copies
    to the host are queued behind the work that produces them and waited
    on one chunk later, or on the media thread;
  * the cluster disturbance draws from one torch.Generator on the device,
    seeded 0, saved with the run state;
  * with spans on (util/profiling.py), the main thread's batch waits,
    copies to the card, warm starts, checkpoints and logs are the spans
    loop.batch_wait, loop.h2d, loop.warm_start, loop.checkpoint and
    loop.log, beside the step's own.

Calibrated multiview data (`data.calibrated=True`, NeRSemble) batches all
views of one timestep per step, with the dataset's cameras (the focal
length is then neither created nor optimized). Missing landmark files are
detected on construction with the configured source (preprocess/landmarks.py)
on the tracker's device.

Several devices (`exp.num_devices`, parallel/sharding.py): one process per
device, each a GlobalTracker in one process group, started by `run_tracker`
(the entry points), `sharding.launch` or torchrun. Every batch is padded
to a multiple of the process count with weight-0 rows and each rank loads
and renders its contiguous block of rows; the parameters and Adam's state
are replicated, the gradients all-reduced before Adam, and the energy's
normalizers, the disturbance pool and the logged terms are the whole
batch's. Each rank draws from its own generator (seeded with its rank).
Rank 0 alone makes the output folder, detects landmarks and writes: logs,
scalars, media, checkpoints and the run state, which holds every rank's
generator. Collectives come from the main thread only; the prefetch and
media threads issue none.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from copy import deepcopy
from datetime import datetime
from pathlib import Path
from queue import Queue
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from vhap_tpu_torch.config.base import BaseTrackingConfig, import_module
from vhap_tpu_torch.config.cli import save_yaml
from vhap_tpu_torch.data.video_dataset import SOURCE_DIRS
from vhap_tpu_torch.device import resolve_device
from vhap_tpu_torch.model.flame import FlameHead, FlameTexPainted, FlameTexPCA
from vhap_tpu_torch.parallel import sharding
from vhap_tpu_torch.tracker import media
from vhap_tpu_torch.tracker import params as P
from vhap_tpu_torch.tracker.energy import make_albedo_fn, make_energy_fn
from vhap_tpu_torch.tracker.optim import leaf_learning_rates, stage_optimizable_leaves
from vhap_tpu_torch.tracker.step_graph import StepGraphs, graphed_train_step
from vhap_tpu_torch.util.log import get_logger
from vhap_tpu_torch.util.profiling import StepTimer, span

# what the media grid and mesh dump read from the evaluation aux
_MEDIA_VIEW_KEYS = ("gt_rgb", "pred_rgb", "error_rgb", "cid", "albedo",
                    "normal", "diffuse", "aa", "gt_lmk2d", "pred_lmk2d",
                    "pred_alpha")


class ScalarWriter:
    """Tensorboard writer if available, JSONL otherwise."""

    def __init__(self, out_dir: Path):
        self.out_dir = Path(out_dir)
        self._tb = None
        self._fh = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(str(out_dir))
        except Exception:
            self._fh = open(self.out_dir / "scalars.jsonl", "a")

    def add_scalar(self, tag: str, value, step: int):
        v = float(value)
        if self._tb is not None:
            self._tb.add_scalar(tag, v, step)
        elif self._fh is not None:
            self._fh.write(json.dumps({"tag": tag, "value": v, "step": step}) + "\n")
            self._fh.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        elif self._fh is not None:
            self._fh.close()
            self._fh = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _NullWriter:
    """The scalar writer of a rank other than 0: it writes nothing."""

    def add_scalar(self, tag: str, value, step: int):
        pass

    def close(self):
        pass


class _HostCopy:
    """Tensors copied to the host behind the device work that makes them:
    pinned buffers and one event on CUDA (`wait` blocks on the event only),
    plain copies on the CPU."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self.arrays: Dict[str, torch.Tensor] = {}
        self._event = None
        for k, v in tensors.items():
            if v.is_cuda:
                dst = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                dst.copy_(v, non_blocking=True)
            else:
                dst = v.detach().clone()
            self.arrays[k] = dst
        if any(v.is_cuda for v in tensors.values()):
            self._event = torch.cuda.Event()
            self._event.record()

    def wait(self) -> Dict[str, np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return {k: v.numpy() for k, v in self.arrays.items()}


class GlobalTracker:
    def __init__(self, cfg: BaseTrackingConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device if device is not None else cfg.device)
        self.calibrated = cfg.data.calibrated
        # this process is rank `rank` of `world` (1 without a process group)
        self.rank, self.world = sharding.rank(), sharding.world()
        self.lead = self.rank == 0
        # exp.num_devices as run_tracker reads it: 0 is every visible card
        if (not sharding.is_distributed()
                and len(sharding.plan(cfg.exp.num_devices, self.device)[0]) > 1):
            raise RuntimeError(
                f"exp.num_devices={cfg.exp.num_devices} runs one process per "
                "device: start the tracker with tracker.run_tracker (the entry "
                "points), parallel.sharding.launch or torchrun, or set "
                "exp.num_devices=1")
        cfg.render.check_portable()
        dev = self.device

        # landmark annotation: detect once unless existing files can be
        # reused; rank 0 detects, the others wait for its files
        sharding.run_on_lead(lambda: self._maybe_detect_landmarks(cfg))

        # model
        self.head = FlameHead.build(
            n_shape=cfg.model.n_shape,
            n_expr=cfg.model.n_expr,
            asset_dir=cfg.model.asset_dir,
            add_teeth=cfg.model.add_teeth,
            remove_lip_inside=cfg.model.remove_lip_inside,
            face_clusters=cfg.model.tex_clusters,
            device=dev,
        )
        assets = self.head.assets
        tex_painted = (FlameTexPainted(assets.tex_painted, cfg.model.tex_resolution,
                                       device=dev)
                       if assets.tex_painted is not None else None)
        tex_pca = (FlameTexPCA(assets.tex_mean, assets.tex_basis, cfg.model.n_tex,
                               cfg.model.tex_resolution, device=dev)
                   if assets.tex_mean is not None else None)
        self.get_albedo = make_albedo_fn(cfg, tex_painted, tex_pca)

        # output dir + logging: rank 0's folder, the only writer
        out_dir = self._new_out_dir(Path(cfg.exp.output_folder)) if self.lead else None
        self.out_dir = Path(sharding.broadcast_object(out_dir))
        if self.lead:
            self.writer = ScalarWriter(self.out_dir)
            save_yaml(cfg, self.out_dir / "config.yml")
        else:
            self.writer = _NullWriter()
        self.logger = get_logger(__name__, root=True,
                                 log_dir=self.out_dir if self.lead else None,
                                 level=logging.INFO if self.lead else logging.WARNING)
        self.logger.info(
            f"Tracking on {dev}" if self.world == 1 else
            f"Tracking on {self.world} processes, the batch sharded and the "
            f"parameters replicated; rank 0 on {dev}")

        # data: calibrated multiview batches every view of one timestep
        self.dataset = import_module(cfg.data._target)(
            cfg=cfg.data, img_to_tensor=True,
            batchify_all_views=self.calibrated)
        self.batchify_all_views = self.dataset.batchify_all_views
        rgb0 = self.dataset[0]["rgb"]
        self.image_size = tuple(rgb0.shape[-3:-1])
        self.n_timesteps = len(self.dataset)

        # parameters
        self.params = P.init_params(
            n_timesteps=self.n_timesteps,
            n_shape=cfg.model.n_shape,
            n_expr=cfg.model.n_expr,
            n_tex=cfg.model.n_tex,
            num_verts=self.head.num_verts,
            tex_resolution=cfg.model.tex_resolution,
            tex_painted=cfg.model.tex_painted,
            tex_extra=cfg.model.tex_extra,
            lighting_sh=cfg.render.lighting_type == "SH",
            use_static_offset=cfg.model.use_static_offset,
            use_dynamic_offset=cfg.model.use_dynamic_offset,
            calibrated=self.calibrated,
            device=dev,
        )
        if cfg.model.flame_params_path is not None:
            self.params = P.load_from_tracked_flame_params(
                self.params, cfg.model.flame_params_path)
        self.params = sharding.replicate_tree(self.params)

        self.global_step = 0
        self.timestep = cfg.begin_timestep
        self.generator = torch.Generator(device=dev).manual_seed(self.rank)
        # media logging rides one background thread: the device->host copies
        # are queued on the stream, the conversion and image IO run there.
        # At most 4 tasks are in flight, each holding host copies only.
        self._media_pool = ThreadPoolExecutor(max_workers=1,
                                              thread_name_prefix="media")
        self._media_future = None
        self._media_sem = threading.Semaphore(4)
        self._media_lock = threading.Lock()
        self.media_write_s = 0.0    # host time spent writing media (bg thread)
        self.media_blocked_s = 0.0  # main-thread time blocked on media backlog
        self.step_timer = StepTimer(device=self.device)
        self.steps_by_stage: Counter = Counter()   # train steps run, per stage
        self.eval_calls = 0                        # evaluation energies run
        self._step_cache: Dict = {}
        self._step_graphs = StepGraphs()
        self._energy_cache: Dict = {}
        self._lr_map = leaf_learning_rates(cfg)

    @staticmethod
    def _new_out_dir(root: Path) -> Path:
        stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        for i in range(100):
            out = root / (stamp if i == 0 else f"{stamp}_{i}")
            try:
                out.mkdir(parents=True)
                return out
            except FileExistsError:
                continue
        raise FileExistsError(f"no free output folder under {root}")

    def _maybe_detect_landmarks(self, cfg):
        """Detect the landmarks of cfg.data.landmark_source once, on the
        tracker's device, unless exp.reuse_landmarks finds them on disk
        (vhap/model/tracker.py:1263-1277)."""
        if not cfg.data.use_landmark:
            return
        cfg_data = deepcopy(cfg.data)
        cfg_data.use_landmark = False
        probe = import_module(cfg.data._target)(cfg=cfg_data,
                                                batchify_all_views=False)
        source = cfg.data.landmark_source
        lmk_path = probe.get_property_path(SOURCE_DIRS[source], len(probe.items) - 1)
        if cfg.exp.reuse_landmarks and lmk_path.exists():
            return
        from vhap_tpu_torch.preprocess.landmarks import annotate_landmarks
        annotate_landmarks(probe, source=source,
                           n_jobs=cfg.data.landmark_detector_njobs, device=self.device)

    # ------------------------------------------------------------------
    # batching
    # ------------------------------------------------------------------

    def _my_rows(self, rows: List[int], weight: np.ndarray):
        """(this rank's rows, their weights, the whole batch): `rows` and
        `weight` padded to a multiple of the process count
        (sharding.pad_batch_to_devices) and cut into contiguous blocks
        (sharding.shard_batch)."""
        full = sharding.pad_batch_to_devices(
            {"row": np.asarray(rows), "weight": weight}, self.world)
        mine = sharding.shard_batch(full, self.rank, self.world)
        return [int(r) for r in mine["row"]], mine["weight"], full

    def _host_batch(self, indices: List[int]) -> Dict[str, torch.Tensor]:
        """Collate frame indices into a padded host batch (pinned when the
        tracker computes on the card); padded samples have weight 0. With
        all views batched, `indices` is one timestep and the batch its
        views, with their cameras (vhap_tpu/tracker/tracker.py:205-221).
        Under a process group this rank loads its block of the batch's rows
        only; the whole batch's timestep indices and weights ride along as
        `global_timestep_index` and `global_weight`."""
        if self.batchify_all_views:
            assert len(indices) == 1
            t = indices[0]
            n = self.dataset.num_cameras
            views, weight, full = self._my_rows(list(range(n)), np.ones(n, np.float32))
            item = self.dataset.getitem_by_timestep(t, views if self.world > 1 else None)
            k = len(views)
            batch = {
                "rgb": torch.from_numpy(np.asarray(item["rgb"], np.float32)),
                "timestep_index": torch.full((k,), t, dtype=torch.int32),
                "weight": torch.from_numpy(weight),
            }
            for key in ("lmk2d", "intrinsic", "extrinsic"):
                if key in item:
                    batch[key] = torch.from_numpy(np.asarray(item[key], np.float32))
            if self.world > 1:
                batch["global_timestep_index"] = torch.full(
                    (len(full["row"]),), t, dtype=torch.int32)
                batch["global_weight"] = torch.from_numpy(full["weight"])
            return self._pin(batch)
        bs = self.cfg.batch_size
        pad = bs - len(indices)
        idx = list(indices) + [indices[-1]] * pad
        weight = np.asarray([1.0] * len(indices) + [0.0] * pad, np.float32)
        idx, weight, full = self._my_rows(idx, weight)
        # the C++ loader where the dataset qualifies, else PIL frame by frame
        # (vhap_tpu/tracker/tracker.py:229-240)
        native = (self.dataset.load_batch_native(idx)
                  if hasattr(self.dataset, "load_batch_native") else None)
        if native is not None:
            rgb = native[0]
            ts = [self.dataset.items[i]["timestep_index"] for i in idx]
            lmks = ([self.dataset.load_lmk2d(i) for i in idx]
                    if self.cfg.data.use_landmark else None)
        else:
            items = [self.dataset[i] for i in idx]
            if hasattr(self.dataset, "pil_batches"):
                self.dataset.pil_batches += 1
            rgb = np.stack([it["rgb"] for it in items])
            ts = [it["timestep_index"] for it in items]
            lmks = [it["lmk2d"] for it in items] if "lmk2d" in items[0] else None
        batch = {
            "rgb": torch.from_numpy(rgb.astype(np.float32, copy=False)),
            "timestep_index": torch.from_numpy(np.asarray(ts, np.int32)),
            "weight": torch.from_numpy(weight),
        }
        if lmks is not None:
            batch["lmk2d"] = torch.from_numpy(np.stack(lmks).astype(np.float32))
        if self.world > 1:
            batch["global_timestep_index"] = torch.from_numpy(np.asarray(
                [self.dataset.items[i]["timestep_index"] for i in full["row"]],
                np.int32))
            batch["global_weight"] = torch.from_numpy(full["weight"])
        return self._pin(batch)

    @staticmethod
    def _global_rows(host: Dict[str, torch.Tensor]):
        """The whole batch's (timestep indices, weights) of a host batch."""
        return (host.get("global_timestep_index", host["timestep_index"]).numpy(),
                host.get("global_weight", host["weight"]).numpy())

    def _pin(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.device.type == "cuda":
            batch = {k: v.pin_memory() for k, v in batch.items()}
        return batch

    def _to_device(self, host: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        with span("loop.h2d"):
            return {k: v.to(self.device, non_blocking=True) for k, v in host.items()}

    def _make_batch(self, indices: List[int]) -> Dict[str, torch.Tensor]:
        """Collate frame indices into a padded device batch."""
        return self._to_device(self._host_batch(indices))

    def _batches(self, shuffle: bool, seed: int = 0) -> Iterable[Dict]:
        """Host batches over all frames (timesteps, with all views
        batched), in order or shuffled."""
        bs = 1 if self.batchify_all_views else self.cfg.batch_size
        order = np.arange(self.n_timesteps)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for i in range(0, len(order), bs):
            yield self._host_batch([int(x) for x in order[i:i + bs]])

    def _prefetch(self, gen, depth: int = 2):
        """Run a host-batch generator on a thread, `depth` batches ahead."""
        q: Queue = Queue(maxsize=depth)
        stop = object()

        def worker():
            try:
                for item in gen:
                    q.put(item)
            except BaseException as e:       # re-raised on the main thread
                q.put(e)
            q.put(stop)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            with span("loop.batch_wait"):
                item = q.get()
            if item is stop:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    # ------------------------------------------------------------------
    # stage machinery
    # ------------------------------------------------------------------

    def _get_step(self, stage: str, lr_scale: float):
        key = (stage, lr_scale)
        if key not in self._step_cache:
            energy = make_energy_fn(
                self.head, self.cfg, self.get_albedo, self.image_size,
                self.n_timesteps, stage, with_aux=False, device=self.device)
            opt_leaves = stage_optimizable_leaves(self.cfg, stage, self.params)
            self._step_cache[key] = graphed_train_step(
                energy, opt_leaves, self._lr_map, lr_scale, self._step_graphs)
        return self._step_cache[key]

    def optimize_stage(self, stage: str, batch=None, batches=None,
                       lr_scale: float = 1.0):
        """One stage on a fixed device batch (init/sequential) or over a
        host-batch loader `batches(epoch)` (global), per
        vhap/model/tracker.py:1391-1416."""
        init_fn, step_fn = self._get_step(stage, lr_scale)
        opt_state = init_fn(self.params)
        stage_cfg = self.cfg.pipeline[stage]
        self.step_timer.reset_clock()

        if batch is not None:
            for _ in range(stage_cfg.num_steps):
                self.params, opt_state, E, log = step_fn(
                    self.params, opt_state, batch, self.generator, 1.0)
                self._log_train(log, batch, stage)
        else:
            num_epochs = stage_cfg.num_epochs
            for epoch_i in range(num_epochs):
                self.logger.info(f"EPOCH {epoch_i + 1} / {num_epochs}")
                # the JAX package's float32 factor
                lr_factor = float(np.float32(0.9 ** epoch_i))
                for host in self._prefetch(batches(epoch_i)):
                    b = self._to_device(host)
                    self.params, opt_state, E, log = step_fn(
                        self.params, opt_state, b, self.generator, lr_factor)
                    self._log_train(log, b, stage)
                if (epoch_i + 1) % 10 == 0:
                    self.evaluate(epoch=epoch_i + 1)

    def _log_train(self, log, batch, stage):
        self.global_step += 1
        self.steps_by_stage[stage] += 1
        self.step_timer.tick(stage)
        with span("loop.log"):
            interval = self.cfg.log.interval_scalar or 100
            if self.global_step % interval == 0:
                vals = self._read_log(log)                       # the one sync
                if not np.isfinite(vals["total"]):
                    self.logger.error(
                        f"[train-{stage}] step {self.global_step}: non-finite "
                        f"energy {[k for k, v in vals.items() if not np.isfinite(v)]}"
                        " — parameters are likely diverging")
                timestep = int(batch["timestep_index"][0])
                sps = self.step_timer.steps_per_sec
                msg = "  ".join(f"{k}: {v:.4f}" for k, v in vals.items())
                self.logger.info(f"[train-{stage}] timestep {timestep} "
                                 f"step {self.global_step} ({sps:.2f} it/s):  {msg}")
                for k, v in vals.items():
                    self.writer.add_scalar(f"train/{k}", v, self.global_step)
                self.writer.add_scalar("perf/steps_per_sec", sps, self.global_step)
            media_interval = self.cfg.log.interval_media or 500
            if self.global_step % media_interval == 0:
                self._log_media(batch, stage=stage)

    @staticmethod
    def _read_log(log: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """The log's values on the host, summed over the ranks (each rank's
        terms are its shares of the batch's)."""
        keys = list(log)
        v = sharding.all_reduce_sum(torch.stack([log[k].reshape(()) for k in keys]))
        return dict(zip(keys, v.tolist()))

    # ------------------------------------------------------------------
    # mid-run checkpoint / resume
    # ------------------------------------------------------------------

    def save_run_state(self, phase: str, cursor: int, epoch: int = 0):
        """Resumable snapshot: params + schedule cursor + generator state
        (a uint8 array under `key`; under a process group every rank's, one
        row each). Rank 0 writes it."""
        with span("loop.checkpoint"):
            key = self.generator.get_state()
            if self.world > 1:
                key = sharding.all_gather_rows(key.to(torch.int32)[None]).to(torch.uint8)
            if not self.lead:
                return
            state = {f"param/{k}": v.detach().cpu().numpy()
                     for k, v in self.params.items()}
            state.update({
                "phase": np.asarray(phase),
                "cursor": np.asarray(cursor),
                "epoch": np.asarray(epoch),
                "global_step": np.asarray(self.global_step),
                "key": key.numpy(),
            })
            np.savez(self.out_dir / "run_state.npz", **state)

    def load_run_state(self, path) -> Dict:
        with np.load(path, allow_pickle=True) as z:
            for k in z.files:
                if k.startswith("param/"):
                    name = k[len("param/"):]
                    if name in self.params:
                        self.params[name] = torch.as_tensor(
                            np.asarray(z[k], np.float32), device=self.device)
            self.params = sharding.replicate_tree(self.params)
            self.global_step = int(z["global_step"])
            key = np.asarray(z["key"])
            if key.dtype == np.uint8 and key.ndim == 1 and self.world == 1:
                self.generator.set_state(torch.from_numpy(key.copy()))
            elif key.dtype == np.uint8 and key.shape[0] == self.world and key.ndim == 2:
                self.generator.set_state(torch.from_numpy(key[self.rank].copy()))
            elif key.dtype == np.uint8:
                self.logger.warning(
                    f"run state of {key.shape[0] if key.ndim == 2 else 1} "
                    f"process(es)' generators, run on {self.world}: keeping "
                    f"seed {self.rank}")
            else:
                # a JAX PRNG key: its stream cannot be continued here
                self.logger.warning(f"run state key of dtype {key.dtype} is not "
                                    "a torch generator state; keeping seed 0")
            return {"phase": str(z["phase"]), "cursor": int(z["cursor"]),
                    "epoch": int(z["epoch"])}

    # ------------------------------------------------------------------
    # main schedule (vhap/model/tracker.py:1343-1389)
    # ------------------------------------------------------------------

    def optimize(self, resume_state_path=None):
        cfg = self.cfg
        resume = None
        if resume_state_path is not None:
            resume = self.load_run_state(resume_state_path)
            self.logger.info(f"Resuming from {resume_state_path}: {resume}")

        skip_until = resume["cursor"] if resume and resume["phase"] == "sequential" else -1
        skip_sequential = bool(resume) and resume["phase"] == "global"

        self.logger.info(
            f"Start sequential tracking FLAME in {self.n_timesteps} frames")
        if not skip_sequential:
            self._run_sequential_phase(skip_until)

        self.evaluate(epoch=0)

        self.logger.info("Start global optimization of all frames")
        stage = ("rgb_global_tracking" if cfg.exp.photometric
                 else "lmk_global_tracking")
        self.optimize_stage(
            stage,
            batches=lambda epoch: self._batches(shuffle=True, seed=epoch),
            lr_scale=0.1)
        self.save_run_state("done", 0)
        self.flush_media()
        self.writer.close()
        self.logger.info("All done.")

    def _run_sequential_phase(self, skip_until: int = -1):
        cfg = self.cfg
        for host in self._prefetch(self._batches(shuffle=False)):
            ts, w = self._global_rows(host)
            if skip_until >= 0 and int(ts[0]) <= skip_until:
                continue
            batch = self._to_device(host)
            if int(ts[0]) == 0:
                self.optimize_stage("lmk_init_rigid", batch)
                self.optimize_stage("lmk_init_all", batch)
                if cfg.exp.photometric:
                    self.optimize_stage("rgb_init_texture", batch)
                    self.optimize_stage("rgb_init_all", batch)
                    if cfg.model.use_static_offset:
                        self.optimize_stage("rgb_init_offset", batch)

            if cfg.exp.photometric:
                self.optimize_stage("rgb_sequential_tracking", batch)
            else:
                self.optimize_stage("lmk_sequential_tracking", batch)
            self._initialize_next_timestep(ts, w)
            self.save_run_state("sequential", int(ts[w > 0][-1]))
        self.save_run_state("global", 0)

    def _initialize_next_timestep(self, ts: np.ndarray, w: np.ndarray):
        """Warm-start the following frames (vhap/model/tracker.py:1515-1529)."""
        with span("loop.warm_start"):
            real = ts[w > 0]
            stride = int(real[-1]) - int(real[0]) + 1
            t_src = int(real[-1])
            targets = [t for t in range(t_src + 1, t_src + 1 + stride)
                       if t < self.n_timesteps - 1]
            if targets:
                self.params = P.copy_forward(self.params, t_src, targets)
            self.timestep = t_src + 1

    # ------------------------------------------------------------------
    # evaluation + checkpoints (vhap/model/tracker.py:1078-1117)
    # ------------------------------------------------------------------

    def _eval_energy(self):
        if "eval" not in self._energy_cache:
            energy = make_energy_fn(
                self.head, self.cfg, self.get_albedo, self.image_size,
                self.n_timesteps, None, with_aux=True, device=self.device)

            def eval_energy(params, batch):
                self.eval_calls += 1
                with torch.no_grad():
                    return energy(params, batch)
            self._energy_cache["eval"] = eval_energy
        return self._energy_cache["eval"]

    def _view_indices(self, num_views: int):
        log = self.cfg.log
        return log.view_indices or tuple(range(
            0, num_views, max(1, (num_views - 1) // max(1, log.max_num_views - 1))
        ))[:log.max_num_views]

    def _media_copy(self, aux, batch) -> _HostCopy:
        """Queue the host copies the media writer needs: the grid's views
        of the image buffers, the first sample's mesh and the albedo map.
        Under a process group the views are gathered from the ranks that
        hold them (collectives; every rank calls this)."""
        n_rows = (self.dataset.num_cameras if self.batchify_all_views
                  else self.cfg.batch_size)     # the one-process batch's rows
        vi = list(self._view_indices(n_rows))
        out = {k: sharding.select_rows(aux[k], vi) for k in _MEDIA_VIEW_KEYS if k in aux}
        if "verts" in aux:
            out["verts"] = sharding.select_rows(aux["verts"], [0])
            out["albedo_map"] = aux["albedo_map"][:1]
        out["timestep_index"] = sharding.select_rows(batch["timestep_index"], [0])
        return _HostCopy(out)

    def evaluate(self, make_visualization: bool = True, epoch: int = 0):
        self.save_result(epoch=epoch)
        self.logger.info("Started Evaluation")
        energy = self._eval_energy()
        photo = []
        # batch_size timesteps per step (one with all views batched);
        # per-timestep scalars come from the *_per_sample aux terms, each
        # normalized by its own foreground area like the reference's
        # per-timestep loop, or, with all views batched, from the step's
        # log, which is then the timestep's value
        bs = 1 if self.batchify_all_views else self.cfg.batch_size
        chunks = [list(range(i, min(i + bs, self.n_timesteps)))
                  for i in range(0, self.n_timesteps, bs)]
        media_every = max(1, self.n_timesteps // 10)

        def drain(item):
            """Host-side extraction for one finished chunk: waits for its
            copies, which were queued before the next chunk's launches."""
            chunk, per_copy, media_copy = item
            per = {k[:-len("_per_sample")]: v for k, v in per_copy.wait().items()}
            for j, t in enumerate(chunk):
                vals = {k: float(v[j]) for k, v in per.items()}
                for k, v in vals.items():
                    self.writer.add_scalar(f"eval/{k}", v, t)
                if "photo" in vals:
                    photo.append(vals["photo"])
                msg = "  ".join(f"{k}: {v:.4f}" for k, v in vals.items())
                self.logger.info(f"[eval] timestep {t}:  {msg}")
                if media_copy is not None and t % media_every == 0:
                    def task(copy=media_copy, t=t):
                        self._save_media(copy.wait(), session=f"eval_{epoch}",
                                         timestep=t)
                    self._submit_media(task)

        # software pipeline: the next chunk is dispatched before the
        # previous chunk's scalars are read
        pending = None
        for chunk in chunks:
            batch = self._make_batch(chunk)
            E, (log, aux) = energy(self.params, batch)
            if self.batchify_all_views:
                keys = [k for k in ("lmk", "photo", "total") if k in log]
                per = sharding.all_reduce_sum(torch.stack([log[k] for k in keys]))
                per_copy = _HostCopy({f"{k}_per_sample": per[i].reshape(1)
                                      for i, k in enumerate(keys)})
            else:
                per_copy = _HostCopy({k: sharding.all_gather_rows(v)
                                      for k, v in aux.items()
                                      if k.endswith("_per_sample")})
            media_copy = (self._media_copy(aux, batch)
                          if make_visualization
                          and any(t % media_every == 0 for t in chunk) else None)
            if pending is not None:
                drain(pending)
            pending = (chunk, per_copy, media_copy)
        if pending is not None:
            drain(pending)
        if photo:
            self.writer.add_scalar("eval_mean/photo", float(np.mean(photo)), epoch)

    def _log_media(self, batch, stage: Optional[str]):
        try:
            E, (log, aux) = self._eval_energy()(self.params, batch)
            copy = self._media_copy(aux, batch)
            if not self.lead:
                return
            step = self.global_step

            def task():
                arrays = copy.wait()
                self._save_media(arrays, session="train",
                                 timestep=int(arrays["timestep_index"][0]),
                                 stage=stage, step=step)
            self._submit_media(task)
        except Exception as e:  # media logging must never kill a run ...
            if self.world > 1:
                # ... but a rank that skipped the collectives above would
                # leave the others waiting in them
                raise
            self.logger.warning(f"media logging failed: {e}")

    def _submit_media(self, task):
        """Submit a media-write task to the single background writer,
        blocking while 4 tasks are in flight. The wait is accounted to
        `media_blocked_s`; the write itself to `media_write_s`. Rank 0
        writes; the others drop the task."""
        if not self.lead:
            return
        t0 = time.perf_counter()
        self._media_sem.acquire()
        waited = time.perf_counter() - t0
        if waited > 1e-4:
            with self._media_lock:
                self.media_blocked_s += waited

        def timed():
            t1 = time.perf_counter()
            try:
                task()
            except Exception as e:  # media never kills a run
                self.logger.warning(f"media logging failed: {e}")
            finally:
                with self._media_lock:
                    self.media_write_s += time.perf_counter() - t1
                self._media_sem.release()

        self._media_future = self._media_pool.submit(timed)

    def flush_media(self):
        """Block until the queued media writes are done."""
        if self._media_future is not None:
            t0 = time.perf_counter()
            self._media_future.result()
            self._media_future = None
            with self._media_lock:
                self.media_blocked_s += time.perf_counter() - t0

    def _save_media(self, out: Dict[str, np.ndarray], session: str,
                    timestep: int, stage: Optional[str] = None,
                    step: Optional[int] = None):
        """Write the grid (and mesh) of one media copy: its arrays hold the
        grid's views only, in order."""
        n_views = out["gt_rgb"].shape[0]
        grid = media.tracking_grid(out, range(n_views),
                                   stack_views_in_rows=self.cfg.log.stack_views_in_rows)
        fmt = self.cfg.log.image_format
        if stage is not None:
            fname = f"frame_{timestep:05d}_{step:03d}_{stage}.{fmt}"
        else:
            fname = f"frame_{timestep:05d}.{fmt}"
        media.save_image(grid, self.out_dir / session / "image_grid" / fname)

        if "verts" in out:
            mesh_dir = self.out_dir / session / "mesh"
            stem = fname[:-len(fmt) - 1]
            a = self.head.assets
            media.save_obj_with_texture(
                out["verts"][0], a.faces, a.verts_uvs, a.textures_idx,
                np.clip(out["albedo_map"][0], 0, 1),
                mesh_dir / f"{stem}.obj", mesh_dir / f"{stem}.mtl",
                mesh_dir / f"{stem}.{fmt}")

    def save_result(self, epoch: Optional[int] = None):
        if not self.lead:
            return
        fname = "tracked_flame_params"
        if epoch is not None:
            fname = f"{fname}_{epoch}"
        P.save_result(
            self.params, self.out_dir / f"{fname}.npz",
            timestep_ids=np.asarray(self.dataset.timestep_ids),
            n_processed=self.timestep,
            image_size=np.asarray(self.image_size),
            calibrated=self.calibrated,
            tex_painted=self.cfg.model.tex_painted)

    def summary(self) -> Dict:
        """What a run leaves besides its files, picklable (a launched
        worker's return value)."""
        return {
            "rank": self.rank, "world": self.world, "device": str(self.device),
            "out_dir": str(self.out_dir), "dataset": type(self.dataset).__name__,
            "calibrated": self.calibrated, "batchify_all_views": self.batchify_all_views,
            "color_correction": bool(getattr(self.dataset, "color_correction", None)),
            "n_timesteps": self.n_timesteps, "global_step": self.global_step,
            "steps_by_stage": dict(self.steps_by_stage),
            "ms_per_step": {st: self.step_timer.median_ms(st)
                            for st in self.steps_by_stage},
            "eval_calls": self.eval_calls,
            "step_graph": self._step_graphs.counts(),
            "collectives": sharding.step_collectives(),
            "media_write_s": self.media_write_s,
            "media_blocked_s": self.media_blocked_s,
            "native_batches": getattr(self.dataset, "native_batches", None),
            "pil_batches": getattr(self.dataset, "pil_batches", None),
        }


# the longest wait of one collective in run_tracker's processes: the ranks
# meet at every step, and rank 0's landmark detection is waited for in
# polls (sharding.run_on_lead)
COLLECTIVE_TIMEOUT_S = 300.0


def track_worker(device, cfg: BaseTrackingConfig) -> Dict:
    """Track on `device` (None: cfg.device), resuming from
    cfg.exp.resume_run_state if set, and return the summary: one rank of a
    launched run (sharding.launch), or the whole of a one-process one."""
    tr = GlobalTracker(cfg, device)
    tr.optimize(resume_state_path=cfg.exp.resume_run_state)
    return tr.summary()


def run_tracker(cfg: BaseTrackingConfig) -> Dict:
    """Track as the entry points do and return the run's summary (rank
    0's). One device (cfg.exp.num_devices and cfg.device, sharding.plan):
    a GlobalTracker in this process. Several: one process per device
    through sharding.launch (NCCL on the cards, gloo with device 'cpu'); a
    failing rank stops the others and makes this raise. Under torchrun
    (RANK / WORLD_SIZE set) this process joins torchrun's group and tracks
    as its rank. A collective that waits COLLECTIVE_TIMEOUT_S fails the
    run."""
    if sharding.from_torchrun() and not sharding.is_distributed():
        dev = sharding.init_from_env(cfg.device, COLLECTIVE_TIMEOUT_S)
        return track_worker(dev, cfg)
    devices, backend = sharding.plan(cfg.exp.num_devices, cfg.device)
    if len(devices) > 1 and not sharding.is_distributed():
        get_logger(__name__).info(
            f"Sharding the batch axis over {len(devices)} devices "
            f"({', '.join(devices)}), one {backend} process each")
        return sharding.launch(track_worker, devices, backend, args=(cfg,),
                               timeout=COLLECTIVE_TIMEOUT_S)[0]
    return track_worker(None, cfg)
