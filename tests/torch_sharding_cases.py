"""Inputs and worker functions of the sharding tests
(tests/test_torch_sharding*.py).

The workers run in processes spawned by vhap_tpu_torch.parallel.sharding.
launch (gloo on the CPU, one torch thread each), so this module imports
numpy, torch and the port only. Every input is made from numpy seeds, the
same in the workers and in the pytest process, where the references run.
"""

from __future__ import annotations

import os
import shutil
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from vhap_tpu_torch.parallel import sharding

NS, NE, R, H, W, T = 20, 10, 64, 32, 128, 4
SEQ_STAGE = "rgb_sequential_tracking"
# the sequential stage with the lights, the static offset and the shape
# optimized too, so that reg_diffuse, the offset regularizers (reg_offset_rigid's
# batch mean among them) and the batch-free reg_shape run
EXTRA_OPT = ("lights", "static_offset", "shape")
STAGES = ("lmk_init_all", SEQ_STAGE)
SEQ = "obama"


def configure(cfg, stage, disturb=False):
    """Either package's BaseTrackingConfig, set up for `stage` at the tests'
    size; the disturbance off unless asked for."""
    cfg.model.n_shape, cfg.model.n_expr, cfg.model.tex_resolution = NS, NE, R
    if not disturb:
        cfg.render.disturb_rate_fg = cfg.render.disturb_rate_bg = None
    if stage == SEQ_STAGE:
        st = cfg.pipeline[stage]
        st.optimizable_params = tuple(st.optimizable_params) + EXTRA_OPT
    return cfg


def inputs(B, V):
    """(params, batch) as numpy dicts: the port's initial parameters
    perturbed (tests/test_torch_train.py's), a random target and landmarks
    on B frames, timesteps 1, 3, 1, ..."""
    from vhap_tpu_torch.tracker import params as TP
    rng = np.random.default_rng(3)
    p = {k: v.numpy().copy() for k, v in TP.init_params(
        T, NS, NE, 100, V, R, True, True, True, True, False, False,
        device="cpu").items()}
    p["translation"][:, 2] = -0.3
    p["translation"] += rng.normal(0, 0.01, p["translation"].shape).astype(np.float32)
    p["expr"] = rng.normal(0, 0.5, p["expr"].shape).astype(np.float32)
    p["rotation"] = rng.normal(0, 0.2, p["rotation"].shape).astype(np.float32)
    p["jaw_pose"] = rng.normal(0, 0.05, p["jaw_pose"].shape).astype(np.float32)
    p["tex_extra"] = rng.normal(0, 0.1, p["tex_extra"].shape).astype(np.float32)
    p["lights"] = p["lights"] + rng.normal(0, 0.3, (9, 3)).astype(np.float32)
    p["static_offset"] = rng.normal(0, 2e-3, p["static_offset"].shape).astype(np.float32)
    batch = {
        "rgb": rng.uniform(size=(B, H, W, 3)).astype(np.float32),
        "lmk2d": np.concatenate([rng.uniform(0, 128, (B, 70, 2)),
                                 rng.uniform(size=(B, 70, 1))], -1).astype(np.float32),
        "timestep_index": ((1 + 2 * np.arange(B)) % T).astype(np.int32),
        "weight": np.ones(B, np.float32),
    }
    return p, batch


def port_head():
    from vhap_tpu_torch.config.base import BaseTrackingConfig
    from vhap_tpu_torch.convert import head_from_assets
    from vhap_tpu_torch.model.assets import load_flame_assets
    a = load_flame_assets(asset_dir="/nonexistent_force_synth", seed=0)
    return head_from_assets(a, NS, NE, face_clusters=BaseTrackingConfig().model.tex_clusters,
                            device="cpu")


def port_energy(th, stage, disturb=False):
    from vhap_tpu_torch.config.base import BaseTrackingConfig
    from vhap_tpu_torch.model.flame import FlameTexPainted
    from vhap_tpu_torch.tracker import energy as TE
    cfg = configure(BaseTrackingConfig(), stage, disturb)
    tex = FlameTexPainted(th.assets.tex_painted, R, device="cpu")
    return cfg, TE.make_energy_fn(th, cfg, TE.make_albedo_fn(cfg, tex, None), (H, W),
                                  T, stage, with_aux=False, device="cpu")


def to_torch(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def port_loss(th, stage, B=2, batch=None):
    """(E, log, grads) of `stage` on this rank's rows of the B-frame batch
    (or of `batch`), as numpy: this rank's shares of E and the log, the
    batch's gradients."""
    from vhap_tpu_torch.convert import params_from_numpy
    from vhap_tpu_torch.tracker import optim as TO
    p, full = inputs(B, th.num_verts)
    local = sharding.shard_padded(full if batch is None else batch)
    cfg, en = port_energy(th, stage)
    leaves = TO.stage_optimizable_leaves(cfg, stage, p)
    E, log, g = TO.loss_and_grads(en, params_from_numpy(p, device="cpu"), leaves,
                                  to_torch(local), torch.Generator().manual_seed(0))
    return (float(E), {k: float(v) for k, v in log.items()},
            {k: v.numpy() for k, v in g.items()})


def reg_diffuse_case(th, d_full):
    """reg_diffuse on this rank's rows of the diffuse image d_full (B, H, W,
    3): (this rank's term, its gradient on those rows)."""
    from vhap_tpu_torch.convert import params_from_numpy
    from vhap_tpu_torch.tracker import energy as TE
    cfg, _ = port_energy(th, SEQ_STAGE)
    p, _ = inputs(2, th.num_verts)
    B = d_full.shape[0]
    local = sharding.shard_padded({"d": d_full, "timestep_index": np.arange(B, dtype=np.int32),
                                   "weight": np.ones(B, np.float32)})
    d = torch.as_tensor(local["d"]).requires_grad_(True)
    opt = {k: k == "lights" for k in ("cam", "pose", "shape", "joints", "expr",
                                      "texture", "lights", "static_offset",
                                      "dynamic_offset")}
    log = TE.regularization_energy(
        params_from_numpy(p, device="cpu"), to_torch({k: local[k] for k in ("timestep_index", "weight")}),
        None, None, None, {"diffuse_detach_normal": d}, th, cfg, SEQ_STAGE, opt,
        TE.build_reg_precomputed(th, cfg), T)
    (g,) = torch.autograd.grad(log["reg_diffuse"], d)
    return float(log["reg_diffuse"].detach()), g.numpy()


def diffuse_image(B=2):
    """A diffuse image whose max (1.5, over 1) lies in the last row."""
    rng = np.random.default_rng(4)
    d = rng.uniform(0.2, 1.2, (B, 8, 16, 3)).astype(np.float32)
    d[-1, 5, 7, 1] = 1.5
    return d


def two_colour():
    """One 16x16 frame of cluster 2 per rank, red on rank 0 and blue on
    rank 1, disturbed at rate 1 with the full pool: this rank's output."""
    from vhap_tpu_torch.ops.render import _cluster_disturbance
    r = sharding.rank()
    colour = torch.tensor([1.0, 0.0, 0.0] if r == 0 else [0.0, 0.0, 1.0])
    rgba = torch.cat([colour.expand(1, 16, 16, 3), torch.ones(1, 16, 16, 1)], -1)
    bg = torch.tensor([1.0, 1.0, 1.0, 0.0]).expand(rgba.shape)
    cid = torch.full((1, 16, 16), 2, dtype=torch.int32)
    return _cluster_disturbance(rgba, bg, cid, torch.Generator().manual_seed(r),
                                1.0, 1.0, num_clusters=4, pool_stride=1).numpy()


def disturbance_inputs(r):
    """Rank r's two 16x16 frames: random clusters 0-3 and colours in
    [0, 1.5); rank 1's second frame is padding (weight 0) of colour 1.9."""
    rng = np.random.default_rng(10 + r)
    cid = rng.integers(0, 4, (2, 16, 16)).astype(np.int32)
    rgb = rng.uniform(0.0, 1.5, (2, 16, 16, 3)).astype(np.float32)
    weight = np.array([1.0, 1.0 if r == 0 else 0.0], np.float32)
    if r == 1:
        rgb[1] = 1.9
    fg = (cid > 0)[..., None]
    bg = np.broadcast_to(np.array([1.0, 1.0, 1.0, 0.0], np.float32), (2, 16, 16, 4))
    rgba = np.where(fg, np.concatenate([rgb, fg.astype(np.float32)], -1), bg)
    return rgba.astype(np.float32), bg, cid, weight


def distribution(rate=0.5):
    from vhap_tpu_torch.ops.render import _cluster_disturbance
    r = sharding.rank()
    rgba, bg, cid, weight = disturbance_inputs(r)
    return _cluster_disturbance(
        torch.as_tensor(rgba), torch.as_tensor(bg), torch.as_tensor(cid),
        torch.Generator().manual_seed(r), rate, rate, num_clusters=4,
        pool_stride=1, sample_weight=torch.as_tensor(weight)).numpy()


def train_steps(th, n_steps=3):
    """n_steps train steps of the sequential stage, the disturbance on, from
    the test parameters on this rank's rows (generator seeded with the
    rank), through the tracker's graphed step, which stays eager on the CPU
    and under gloo; E (disturbance off) before and after, and the
    parameters after. The last step runs with spans on and the bytes of
    every torch.distributed.all_reduce recorded: the step's counts of eager,
    captured and replayed calls, its collectives by caller
    (sharding.step_collectives), the recorded bytes, the parent span of
    each `sharding.all_reduce` span, and the bytes the gradient bucket and
    the disturbance pool should have; and the step's capture verdict for
    these inputs presented as tensors on cuda:0."""
    import torch.distributed as dist

    from vhap_tpu_torch.convert import params_from_numpy
    from vhap_tpu_torch.tracker import optim as TO
    from vhap_tpu_torch.tracker import step_graph
    from vhap_tpu_torch.tracker.step_graph import StepGraphs, graphed_train_step
    from vhap_tpu_torch.util import profiling
    p, full = inputs(2, th.num_verts)
    local = to_torch(sharding.shard_padded(full))
    cfg, en = port_energy(th, SEQ_STAGE, disturb=True)
    _, en_off = port_energy(th, SEQ_STAGE)
    leaves = TO.stage_optimizable_leaves(cfg, SEQ_STAGE, p)
    graphs = StepGraphs()
    init, step = graphed_train_step(en, leaves, TO.leaf_learning_rates(cfg), 1.0, graphs)
    params = params_from_numpy(p, device="cpu")
    gen = torch.Generator().manual_seed(sharding.rank())
    E0 = float(TO.loss_and_grads(en_off, params, leaves, local, gen)[0])
    state = init(params)
    for _ in range(n_steps - 1):
        params, state, _, _ = step(params, state, local, gen)
    reduced, real = [], dist.all_reduce

    def recorded(t, *args, **kwargs):
        reduced.append(t.numel() * t.element_size())
        return real(t, *args, **kwargs)
    dist.all_reduce = recorded
    profiling.take_spans()
    profiling.enable_spans(True)
    try:
        params, state, _, _ = step(params, state, local, gen)
    finally:
        profiling.enable_spans(False)
        dist.all_reduce = real
    spans = profiling.take_spans()
    E1 = float(TO.loss_and_grads(en_off, params, leaves, local, gen)[0])
    n = local["rgb"][..., 0].numel()
    stride = cfg.render.disturb_pool_stride
    # the capture verdict for inputs on one card, as gloo on CUDA tensors
    # presents them: every tensor's device and the generator's cuda:0
    card = torch.device("cuda", 0)
    real_sig = step_graph._signature
    step_graph._signature = lambda ts: (None if real_sig(ts) is None else
                                        tuple(s[:3] + (card,) for s in real_sig(ts)))
    try:
        on_card = step_graph._GraphedStep._may_capture(
            params, local, types.SimpleNamespace(device=card))
    finally:
        step_graph._signature = real_sig
    pool = n // (128 * stride) * 128 if stride > 1 else n
    return {"E0": E0, "E1": E1, "params": {k: v.numpy() for k, v in params.items()},
            "graph": graphs.counts(), "capturable": sharding.capturable(),
            "may_capture_on_card": on_card,
            "agree": [sharding.all_agree(True), sharding.all_agree(sharding.rank() == 0)],
            "tally": sharding.step_collectives(), "reduced": reduced,
            "span_parents": [spans[sp.parent].name if sp.parent >= 0 else None
                             for sp in spans if sp.name == "sharding.all_reduce"],
            "grad_bytes": sum(params[k].numel() * params[k].element_size() for k in leaves),
            "pool_bytes": sharding.world() * pool * 4}


def mv_config(root, out):
    """tests/test_sharding.py's multiview tracker config, on the port."""
    from vhap_tpu_torch.config.nersemble import NersembleTrackingConfig
    cfg = NersembleTrackingConfig()
    cfg.data.root_folder = Path(root)
    cfg.data.subject, cfg.data.sequence = "001", "SEN-01"
    cfg.data.align_cameras_to_axes = False
    cfg.data.use_color_correction = False
    cfg.data.background_color = None
    cfg.model.n_shape, cfg.model.n_expr = 30, 10
    cfg.model.add_teeth = False
    cfg.model.use_static_offset = False
    cfg.model.tex_extra = False
    cfg.exp.photometric = False
    cfg.exp.output_folder = Path(out)
    cfg.exp.num_devices = 2
    cfg.w.photo = None
    cfg.pipeline.lmk_init_rigid.num_steps = 5
    cfg.log.interval_scalar = 10 ** 6
    cfg.log.interval_media = 10 ** 6
    cfg.device = "cpu"
    cfg.__post_init__()
    return cfg


def mono_config(root, out, num_devices=2):
    """A photometric monocular run at reduced depth: 4 frames at 32^2,
    batch 2, every stage a few steps, one global epoch, scalars every 2
    steps and media every 5."""
    from vhap_tpu_torch.config.base import BaseTrackingConfig
    cfg = BaseTrackingConfig()
    cfg.data.root_folder = Path(root)
    cfg.data.sequence = SEQ
    cfg.data.background_color = None
    cfg.model.n_shape, cfg.model.n_expr = 50, 20
    cfg.model.add_teeth = False
    cfg.model.use_static_offset = False
    cfg.model.tex_resolution = 32
    cfg.exp.output_folder = Path(out)
    cfg.exp.num_devices = num_devices
    cfg.batch_size = 2
    for stage, n in (("lmk_init_rigid", 3), ("lmk_init_all", 3), ("rgb_init_texture", 2),
                     ("rgb_init_all", 2), ("rgb_sequential_tracking", 2)):
        cfg.pipeline[stage].num_steps = n
    cfg.pipeline.rgb_global_tracking.num_epochs = 1
    cfg.log.interval_scalar, cfg.log.interval_media = 2, 5
    cfg.device = "cpu"
    cfg.__post_init__()
    return cfg


def _audit_writes(root, seen):
    """Record, in `seen`, every file this process opens for writing, and
    every folder it makes or file it moves, under `root`."""
    root = os.fspath(root)

    def under(path):
        try:
            return os.fspath(os.path.abspath(path)).startswith(root)
        except TypeError:
            return False

    def hook(event, args):
        if event == "open":
            path, mode, flags = args
            if isinstance(path, int):
                return
            writing = (any(c in mode for c in "wax+") if mode else
                       bool(flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)))
            if writing and under(path):
                seen.append(f"open {path}")
        elif event in ("os.mkdir", "os.rename", "os.replace") and under(args[0]):
            seen.append(f"{event} {args[0]}")

    sys.addaudithook(hook)


def tracker_multiview(device, rig_root, out):
    from vhap_tpu_torch.tracker.tracker import GlobalTracker
    tr = GlobalTracker(mv_config(rig_root, out), device)
    batch = tr._make_batch([0])
    res = {"rows": int(batch["rgb"].shape[0]), "weight": batch["weight"].numpy(),
           "global_weight": batch["global_weight"].numpy(),
           "views": batch["extrinsic"].numpy()}
    tr.optimize_stage("lmk_init_rigid", batch)
    res["params"] = {k: tr.params[k].numpy() for k in ("rotation", "translation")}
    tr._eval_energy = failing_energy
    try:
        tr._log_media(batch, "lmk_init_rigid")
        res["media_failure"] = None
    except RuntimeError as e:
        res["media_failure"] = str(e)
    return res


def failing_energy():
    """A tracker's _eval_energy whose energy raises."""
    def energy(params, batch):
        raise RuntimeError("eval energy failed")
    return energy


def tracker_mono(device, seq_root, out, kept):
    """The monocular run twice: uninterrupted (keeping a copy of the run
    state written after the sequential phase at `kept`), then resumed from
    that copy. Ranks other than 0 record what they write under `out`."""
    from vhap_tpu_torch.tracker.tracker import GlobalTracker
    writes = []
    if sharding.rank() != 0:
        _audit_writes(out, writes)
    cfg = mono_config(seq_root, out)
    a = GlobalTracker(cfg, device)
    save = a.save_run_state

    def save_and_keep(phase, cursor, epoch=0):
        save(phase, cursor, epoch)
        if phase == "global" and a.lead:
            shutil.copy(a.out_dir / "run_state.npz", kept)

    a.save_run_state = save_and_keep
    a.optimize()
    b = GlobalTracker(cfg, device)
    b.optimize(resume_state_path=kept)
    return {"a": {k: v.numpy() for k, v in a.params.items()},
            "b": {k: v.numpy() for k, v in b.params.items()},
            "a_gen": a.generator.get_state().numpy(),
            "b_gen": b.generator.get_state().numpy(),
            "a_out": str(a.out_dir), "b_out": str(b.out_dir),
            "steps": dict(a.steps_by_stage), "b_steps": dict(b.steps_by_stage),
            "writes": writes}


def two_rank_checks(device, rig_root, seq_root, out_root):
    """Every check of the 2-rank group, in one spawn."""
    # the scalar writer's tensorboard then runs on its own stub, without
    # importing TensorFlow where it is installed (~15 s of CPU), which
    # nothing of the port needs
    sys.modules.setdefault("tensorflow", None)
    th = port_head()
    res = {stage: port_loss(th, stage) for stage in STAGES}
    res["reg_diffuse"] = reg_diffuse_case(th, diffuse_image())
    res["two_colour"] = two_colour()
    res["distribution"] = distribution()
    res["steps"] = train_steps(th)
    out_root = Path(out_root)
    res["mv"] = tracker_multiview(device, rig_root, out_root / "mv")
    res["mono"] = tracker_mono(device, seq_root, out_root / "mono",
                               out_root / "kept_run_state.npz")
    return res


def padded_checks(device):
    """lmk_init_all on 5 frames padded to 8 over 4 ranks."""
    th = port_head()
    _, batch = inputs(5, th.num_verts)
    return port_loss(th, "lmk_init_all", batch=sharding.pad_batch_to_devices(batch, 4))


def train_config(cls, stage):
    """tests/test_torch_train.py's training config, of either package."""
    cfg = cls()
    cfg.model.n_shape, cfg.model.n_expr, cfg.model.tex_resolution = NS, NE, R
    cfg.render.disturb_rate_fg = cfg.render.disturb_rate_bg = None
    if stage == "rgb_init_offset":
        # exercise the boundary detach too (the synthetic head has no
        # "bottomline" region)
        cfg.pipeline.rgb_init_offset.align_boundary_except = ("hair",)
    return cfg


def train_energy_checks(device, p, batch, stages):
    """tests/test_torch_train.py's training energies (its head, config and
    inputs p, batch) on this rank's rows: {stage: (E, log, gradients)}."""
    from vhap_tpu_torch.config.base import BaseTrackingConfig
    from vhap_tpu_torch.convert import head_from_assets, params_from_numpy
    from vhap_tpu_torch.model.assets import load_flame_assets
    from vhap_tpu_torch.model.flame import FlameTexPainted
    from vhap_tpu_torch.tracker import energy as TE
    from vhap_tpu_torch.tracker import optim as TO
    a = load_flame_assets(asset_dir="/nonexistent_force_synth", seed=0)
    a.tex_painted = np.random.default_rng(3).integers(0, 256, (16, 16, 3)).astype(np.uint8)
    th = head_from_assets(a, NS, NE, face_clusters=BaseTrackingConfig().model.tex_clusters,
                          device="cpu")
    local = to_torch(sharding.shard_padded(batch))
    out = {}
    for stage in stages:
        cfg = train_config(BaseTrackingConfig, stage)
        en = TE.make_energy_fn(th, cfg, TE.make_albedo_fn(
            cfg, FlameTexPainted(a.tex_painted, R, device="cpu"), None), (H, W), T,
            stage, device="cpu")
        E, log, g = TO.loss_and_grads(en, params_from_numpy(p, device="cpu"),
                                      TO.stage_optimizable_leaves(cfg, stage, p), local,
                                      torch.Generator().manual_seed(0))
        out[stage] = (float(E), {k: float(v) for k, v in log.items()},
                      {k: v.numpy() for k, v in g.items()})
    return out


def lead_waits(device, wait_s):
    """run_on_lead with rank 0's fn sleeping `wait_s`, then raising: (this
    rank's wait in s, what it raised)."""
    t = time.perf_counter()
    sharding.run_on_lead(lambda: time.sleep(wait_s))
    waited = time.perf_counter() - t

    def fail():
        raise ValueError("rank 0 fails")
    try:
        sharding.run_on_lead(fail)
        raised = None
    except Exception as e:
        raised = f"{type(e).__name__}: {e}"
    return waited, raised


def fails_on_rank_1(device):
    if sharding.rank() == 1:
        raise ValueError("rank 1 fails")
    sharding.all_reduce_sum(torch.zeros(1))


def _draws_recorded():
    """Record every torch.rand / torch.randint result, cloned where it is
    drawn (a graph's clone is rewritten on each replay); returns (draws,
    undo)."""
    draws, real = [], {n: getattr(torch, n) for n in ("rand", "randint")}
    for name, fn in real.items():
        def recorded(*args, _fn=fn, **kwargs):
            out = _fn(*args, **kwargs)
            draws.append(out.clone())
            return out
        setattr(torch, name, recorded)
    return draws, lambda: [setattr(torch, n, fn) for n, fn in real.items()]


def graphed_nccl_steps(device, rig_root, n_steps=5):
    """One NCCL rank of the card test of the sharded graphed step: the
    multiview step (tools/multiview_slice.py at the rig's size, this rank's
    views), n_steps chained from one state and generator seed (the rank's)
    through graphed_train_step (1 eager call, 1 capture, replays), and
    before each graphed call the eager step from the same inputs and
    generator state; then an eager chain from the start. Per step: the
    energy shares, the draws and generator states alike or not, the
    kernels' launches, each leaf's change gap against both (as
    tests/test_torch_kernels_cuda.py's one-card test) and digests of the
    parameters and Adam state; then the calls counted and the collectives
    of the captured step by caller."""
    import hashlib

    from vhap_tpu_torch.ops.kernels import Kernel
    from vhap_tpu_torch.tools.multiview_slice import build_multiview_slice
    from vhap_tpu_torch.tracker.optim import make_train_step
    from vhap_tpu_torch.tracker.step_graph import StepGraphs, graphed_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ts = build_multiview_slice(rig_root, device=device, n_shape=20, n_expr=10, tex_res=64)
    s = ts.eval
    energy = ts.make_energy(True, True)
    keys = sorted(ts.opt_leaves)
    graphs = StepGraphs()
    init, eager_step = make_train_step(energy, ts.opt_leaves, ts.lr_map)
    _, graphed_step = graphed_train_step(energy, ts.opt_leaves, ts.lr_map, 1.0, graphs)
    draws, undo = _draws_recorded()

    def digest(tensors):
        h = hashlib.sha256()
        for k in sorted(tensors):
            h.update(tensors[k].detach().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()

    def call(step, params, state, gen):
        n, n0 = len(draws), {k: k.launches for k in Kernel.made}
        p, st, E, _ = step(params, state, s.batch, gen, 1.0)
        torch.cuda.synchronize()
        return p, st, {"E": float(E), "count": int(st["count"]), "draws": draws[n:],
                       "gen": gen.get_state(), "params": {k: p[k].clone() for k in keys},
                       "launches": {k.symbol: k.launches - n0.get(k, 0) for k in Kernel.made},
                       "digest": digest({**p, **{f"{m}.{k}": v for m in ("mu", "nu")
                                                 for k, v in st[m].items()}})}

    def gaps(p0, a, b):
        out = {}
        for k in keys:
            na = float(torch.linalg.vector_norm((a[k] - p0[k]).double()))
            nb = float(torch.linalg.vector_norm((b[k] - p0[k]).double()))
            out[k] = abs(na - nb) / max(nb, 1e-30)
        return out

    try:
        seed = 1234567 + sharding.rank()
        gen = ts.generator(seed)
        params, state = s.params, init(s.params)
        graphed, alone, recorded = [], [], {}
        for i in range(n_steps):
            start = gen.get_state()
            alone.append(call(eager_step, params, state, gen)[2])
            gen.set_state(start)
            before, turn = graphs.counts(), getattr(graphed_step, "turn", 0)
            params, state, g = call(graphed_step, params, state, gen)
            if graphs.captures > before["captures"]:   # both graphs' draws
                half = len(g["draws"]) // 2
                recorded = {0: g["draws"][:half], 1: g["draws"][half:]}
            if graphs.eager == before["eager"]:        # this call's graph
                g["draws"] = [d.clone() for d in recorded[turn]]
            graphed.append(g)
        tally = sharding.step_collectives()
        gen = ts.generator(seed)
        params, state, chain = s.params, init(s.params), []
        for i in range(n_steps):
            params, state, e = call(eager_step, params, state, gen)
            chain.append(e)
    finally:
        undo()
    steps, prev = [], {k: s.params[k] for k in keys}
    for g, e, c in zip(graphed, alone, chain):
        steps.append({
            "E": [g["E"], e["E"]], "count": [g["count"], e["count"], c["count"]],
            "n_draws": [len(g["draws"]), len(e["draws"]), len(c["draws"])],
            "draws_equal": [len(g["draws"]) == len(r["draws"]) and all(
                torch.equal(a, b) for a, b in zip(g["draws"], r["draws"])) for r in (e, c)],
            "gen_equal": [torch.equal(g["gen"], r["gen"]) for r in (e, c)],
            "launches": [g["launches"], e["launches"]],
            "one": gaps(prev, g["params"], e["params"]),
            "chained": gaps(s.params, g["params"], c["params"]),
            "digest": [g["digest"], c["digest"]]})
        prev = g["params"]
    return {"steps": steps, "graph": graphs.counts(), "tally": tally,
            "capturable": sharding.capturable()}
