"""One run of one cell: the tracker's own loop, timed, traced on request,
and checked against the plain reference.

Set-up: the cell's head, frames, landmarks and cameras are written from
the seed under TMPDIR (traffic/), a GlobalTracker is built from the
configuration, its disturbance generator is seeded from the seed, and the
loop starts. The first `warmup_batches` batch boundaries are set-up; so are
the stage's first three steps, which the reference follows later.

Window: the loop runs on, untouched, until the first batch boundary after
`seconds`, where the harness ends it (it raises out of the loop at that
boundary; it adds and removes no step). `step_ms` is the window's host time
(closed by torch.cuda.synchronize()) over the steps the tracker counted in
it; `step_p95_ms` the 95th percentile of the tracker's own step intervals
(StepTimer) in it. With --trace 1 the first `trace_batches` boundaries
after set-up run under torch.profiler, and the window of `seconds` follows
untraced.

Sequential stage: `_run_sequential_phase`, a batch boundary after each
batch's `save_run_state`. Global stage: `optimize_stage(stage,
batches=..., lr_scale)` over the tracker's shuffled `_batches`, one epoch
after another in one stream (so the evaluation every 10 epochs stays out),
a boundary after every step.
"""

from __future__ import annotations

import gc
import itertools
import os
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

import cellspec
from reference import check
from traffic import head as head_assets
from traffic import scene

FORBIDDEN = ("jax", "jaxlib", "flax", "vhap_tpu")

# tensorboard, which the tracker's scalar writer takes where it is
# installed, imports TensorFlow where that is installed, and TensorFlow
# imports JAX; tensorboard writes without it
sys.modules.setdefault("tensorflow", None)


class WindowClosed(Exception):
    """Raised at the batch boundary that ends the window."""


class Window:
    """Batch-boundary bookkeeping of one run (main thread only)."""

    def __init__(self, tracker, stage: str, seconds: float, warmup: int,
                 trace: int):
        self.tr, self.stage, self.seconds = tracker, stage, seconds
        self.warmup, self.trace = warmup, trace
        self.n = 0
        self.state = "warmup"
        self.prof = None
        self.marks: Dict[str, tuple] = {}

    def _mark(self, name: str) -> None:
        if self.tr.device.type == "cuda":
            torch.cuda.synchronize()
        self.marks[name] = (time.perf_counter(), self.tr.steps_by_stage[self.stage],
                            len(self.tr.step_timer.stage_deltas[self.stage]))

    def boundary(self) -> None:
        self.n += 1
        if self.state == "warmup":
            if self.n >= self.warmup:
                self._mark("start")
                if self.trace:
                    self.prof = start_profiler()
                    self.state, self.n = "traced", 0
                else:
                    self.state = "window"
        elif self.state == "traced":
            if self.n >= self.trace:
                self._mark("traced_end")
                self.prof.__exit__(None, None, None)
                self._mark("window_start")
                self.state = "window"
        elif self.state == "window":
            from vhap_tpu_torch.parallel import sharding
            t0 = self.marks.get("window_start", self.marks["start"])[0]
            # under a process group rank 0's clock decides for every rank
            if sharding.broadcast_object(time.perf_counter() - t0 >= self.seconds):
                self._mark("end")
                raise WindowClosed


def start_profiler():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


class Capture:
    """Keeps what the stage's first three steps produced: each energy, the
    Adam state after step 1, the parameters before and after, and the norm
    of the change step 1 made."""

    def __init__(self, tracker, stage: str, lr_scale: float,
                 fault: Optional[Callable] = None):
        self.E: List[torch.Tensor] = []
        init_fn, step_fn = tracker._get_step(stage, lr_scale)
        self.opt_leaves = sorted(check.stage_optimizable_leaves(
            tracker.cfg, stage, tracker.params))
        inner = fault(step_fn) if fault is not None else step_fn

        def step(params, opt_state, batch, generator, lr_factor=1.0):
            i = len(self.E)
            if i >= check.STEPS:
                return inner(params, opt_state, batch, generator, lr_factor)
            if i == 0:
                self.p0 = {k: params[k].detach().clone() for k in self.opt_leaves}
                self.rows = []
            self.rows.append(batch.get("global_timestep_index",
                                       batch["timestep_index"]))
            out = inner(params, opt_state, batch, generator, lr_factor)
            self.E.append(out[2].detach().clone())
            if i == 0:
                self.mu1 = {k: out[1]["mu"][k].detach().clone() for k in self.opt_leaves}
                self.first = {k: check.norm(out[0][k] - self.p0[k]) for k in self.opt_leaves}
            if i == check.STEPS - 1:
                self.p3 = {k: out[0][k].detach().clone() for k in self.opt_leaves}
            return out

        tracker._step_cache[(stage, lr_scale)] = (init_fn, step)

    def readings(self) -> Dict:
        if len(self.E) < check.STEPS:
            raise RuntimeError(f"the stage ran {len(self.E)} of its first "
                               f"{check.STEPS} steps before the window closed")
        return {"E": [float(e) for e in self.E],
                "grad": {k: check.norm(self.mu1[k] / (1 - check.BETA1))
                         for k in self.opt_leaves},
                "change_first": self.first,
                "change": {k: check.norm(self.p3[k] - self.p0[k])
                           for k in self.opt_leaves}}


def no_exchange(step):
    """A fault of a sharded cell: a step whose gradients skip the all-reduce
    between processes, so each rank steps on its own rows' share."""
    def faulty(*args, **kwargs):
        from vhap_tpu_torch.parallel import sharding
        real = sharding.all_reduce_grads
        sharding.all_reduce_grads = lambda grads: grads
        try:
            return step(*args, **kwargs)
        finally:
            sharding.all_reduce_grads = real
    return faulty


def port_classes():
    from vhap_tpu_torch.config.base import BaseTrackingConfig
    from vhap_tpu_torch.config.nersemble import NersembleTrackingConfig
    return {"base": BaseTrackingConfig, "nersemble": NersembleTrackingConfig}


def _timed_batches(tracker, times: List[float]):
    """The tracker's `_batches`, each next() timed (on the prefetch thread)."""
    orig = tracker._batches

    def batches(shuffle: bool, seed: int = 0):
        gen = orig(shuffle, seed)
        while True:
            t = time.perf_counter()
            try:
                b = next(gen)
            except StopIteration:
                return
            times.append(time.perf_counter() - t)
            yield b
    tracker._batches = batches


def _after(obj, name: str, hook: Callable[[], None]) -> None:
    """Call hook() after each call of obj.name (an instance override)."""
    orig = getattr(obj, name)

    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs)
        hook()
        return out
    setattr(obj, name, wrapped)


def run(workload: str, seed: int, seconds: float, trace: bool, t_process: float,
        device: str = "cuda", overrides: Optional[Dict] = None,
        fault: Optional[Callable] = None) -> Dict:
    """Run the cell once; returns the result record (see run.py)."""
    spec = cellspec.cell(workload, overrides)
    traffic = spec["traffic"]
    stage, lr_scale = traffic["stage"], float(traffic["lr_scale"])
    s = int(seed) % (2 ** 62)
    base = Path(tempfile.mkdtemp(prefix="vhap_bench_", dir=os.environ.get("TMPDIR")))
    try:
        return _run(spec, s, seconds, trace, t_process, device, base, stage,
                    lr_scale, fault)
    finally:
        shutil.rmtree(base, ignore_errors=True)


def _run(spec, s, seconds, trace, t_process, device, base, stage, lr_scale, fault):
    traffic, conf = spec["traffic"], spec["config"]
    chips = spec["workload"]["chips"]
    dev = torch.device(device)
    T = cellspec.n_timesteps(spec)
    asset_dir = head_assets.write_assets(base / "assets", s)
    model = conf["tracker"]["model"]
    # a sharded cell's ranks own the cards: this process writes the scene
    # on the host and touches a card only for the reference, after them
    data = scene.write_scene(base / "data", conf["scene"], model, T, s, asset_dir,
                             dev if chips == 1 else torch.device("cpu"))
    cfg = cellspec.tracking_config(spec, port_classes(), data, asset_dir,
                                   base / "output", device)
    cfg.exp.num_devices = chips
    args = (cfg, spec, s, seconds, trace, t_process, fault)
    if chips == 1:
        ranks = [drive(None, *args)]
    else:
        from vhap_tpu_torch.parallel import sharding
        from vhap_tpu_torch.tracker.tracker import COLLECTIVE_TIMEOUT_S
        devices, backend = sharding.plan(chips, device)
        if len(devices) != chips:
            raise RuntimeError(f"the cell needs {chips} devices, found {devices}")
        ranks = sharding.launch(drive, devices, backend, args=args,
                                timeout=COLLECTIVE_TIMEOUT_S,
                                num_threads=2 if dev.type == "cpu" else None)
    rec = ranks[0]
    rec["world"] = len(ranks)
    rec["memory_peak_bytes"] = max(r["memory_peak_bytes"] for r in ranks)
    if trace:
        rec["busy_s"] = statistics.mean(r["busy_s"] for r in ranks)
    readings = [r.pop("readings") for r in ranks]
    prog = dict(readings[0])
    # each rank's energy is its share of the batch's
    prog["E"] = [sum(es) for es in zip(*(x["E"] for x in readings))]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec["forbidden_modules"] = sorted({m.split(".")[0] for m in sys.modules}
                                      & set(FORBIDDEN))

    ref_cfg = cellspec.tracking_config(spec, check.CLASSES, data, asset_dir,
                                       base / "output", device)
    rows = rec.pop("rows")
    world = len(ranks)
    batch = len(rows[0]) if conf["scene"]["layout"] != "rig" else conf["scene"]["cameras"]
    ref = check.follow(ref_cfg, stage, lr_scale, rows, T,
                       [s + r for r in range(world)] if world > 1 else s, dev,
                       count_rows=batch // world)
    rec["counts"] = ref["counts"]
    rec["compared"] = check.compare(prog, ref)
    rec["detail"] = {"E": [prog["E"], ref["E"]],
                     "grad": {k: [prog["grad"][k], ref["grad"][k]] for k in ref["grad"]},
                     "change_first": {k: [prog["change_first"][k], ref["change_first"][k]]
                                      for k in ref["change_first"]},
                     "change": {k: [prog["change"][k], ref["change"][k]] for k in ref["change"]}}
    rec["limits"] = spec["workload"]["limits"]
    rec["correct"] = all(rec["compared"][k] <= v for k, v in rec["limits"].items())
    return rec


def drive(device, cfg, spec, s, seconds, trace, t_process, fault) -> Dict:
    """The tracker's loop in this process (one rank of a launched run, or
    the only process): set-up, the window, and what the stage's first steps
    produced. The program's state is gone when this returns."""
    from vhap_tpu_torch.parallel import sharding
    from vhap_tpu_torch.tracker.tracker import GlobalTracker
    traffic = spec["traffic"]
    stage, lr_scale = traffic["stage"], float(traffic["lr_scale"])
    tracker = GlobalTracker(cfg, device)
    dev = tracker.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rank = sharding.rank()
    tracker.generator.manual_seed(s + rank)
    capture = Capture(tracker, stage, lr_scale, fault)
    batch_times: List[float] = []
    _timed_batches(tracker, batch_times)
    win = Window(tracker, stage, seconds, traffic["warmup_batches"],
                 traffic["trace_batches"] if trace else 0)
    try:
        if traffic["loop"] == "sequential":
            _after(tracker, "save_run_state", win.boundary)
            tracker._run_sequential_phase()
        else:
            _after(tracker, "_log_train", win.boundary)
            epochs = traffic["epochs"]
            tracker.optimize_stage(
                stage, lr_scale=lr_scale,
                batches=lambda epoch: itertools.chain.from_iterable(
                    tracker._batches(shuffle=True, seed=e) for e in range(epochs)))
        raise RuntimeError(f"the sequence ended before the window did ({tracker.n_timesteps} "
                           "timesteps): the cell's traffic is too short")
    except WindowClosed:
        pass

    t_start, n_start, d_start = win.marks["start"]
    t_w0, n_w0, d_w0 = win.marks.get("window_start", win.marks["start"])
    t_end, n_end, d_end = win.marks["end"]
    steps = n_end - n_w0
    # traced: the first interval after the profiler closed spans its close
    deltas = tracker.step_timer.stage_deltas[stage][d_w0 + bool(trace):d_end]
    rec = {
        "cell": spec["name"], "stage": stage, "spec": spec,
        "setup_s": t_start - t_process,
        "window_s": t_end - t_w0, "steps": steps,
        "step_s": (t_end - t_w0) / steps,
        "step_p95_s": float(np.percentile(deltas, 95)) if deltas else None,
        "n_deltas": len(deltas),
        "host_batch_s": batch_times[2:] or batch_times,
        "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                              if dev.type == "cuda" else 0),
    }
    if win.prof is not None:
        t_tr, n_tr, _ = win.marks["traced_end"]
        rec.update(trace_record(win.prof, t_tr - t_start, n_tr - n_start))
    rec["readings"] = capture.readings()
    rows = [r.cpu().numpy().tolist() for r in capture.rows]
    if spec["config"]["scene"]["layout"] == "rig":
        rows = [[r[0]] for r in rows]
    rec["rows"] = rows
    # the program's state goes before the reference runs
    tracker.flush_media()
    tracker.__dict__.clear()
    del tracker, capture
    gc.collect()
    return rec


def trace_record(prof, wall_s: float, steps: int) -> Dict:
    """Device time, launches and the longest idle gaps of a profiled
    sub-window, from the profiler's events."""
    from torch.autograd import DeviceType
    events = prof.events()
    dev_iv, kernel_s, host = [], {}, []
    for ev in events:
        if ev.device_type == DeviceType.CUDA:
            if getattr(ev, "is_user_annotation", False):
                continue
            a, b = ev.time_range.start, ev.time_range.end
            dev_iv.append((a, b))
            kernel_s[ev.name] = kernel_s.get(ev.name, 0.0) + (b - a) / 1e6
        elif ev.device_type == DeviceType.CPU:
            host.append((ev.time_range.start, ev.time_range.end, ev.name))
    dev_iv.sort()
    merged: List[List[float]] = []
    for a, b in dev_iv:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_s = sum(b - a for a, b in merged) / 1e6
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)), reverse=True)[:10]
    named = []
    for length, a, b in gaps:
        mid = (a + b) / 2
        inside = [(e - s, n) for s, e, n in host if s <= mid <= e]
        named.append([min(inside)[1] if inside else "no host op", length / 1e6])
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    return {"traced_wall_s": wall_s, "traced_steps": steps, "busy_s": busy_s,
            "device_ops": len(dev_iv), "kernel_s": kernel_s,
            "breakdown": {"device_ops": [[n[:120], v] for n, v in top],
                          "idle_gaps": named}}
