"""Where the evaluation or train step's device time goes, on one CUDA card.

    python -m vhap_tpu_torch.tools.profile_eval [--stage rgb_sequential_tracking
        [--multiview ROOT] | --vis [--grad]] [--steps 5] [--top 25]

Builds the bench-width evaluation step (tools/eval_slice.py) or, with
--stage, that stage's train step (tools/train_slice.py: forward, backward
and Adam, disturbance on; with --multiview ROOT, the calibrated step on all
views of one timestep of the NeRSemble rig at ROOT, written by
tools/multiview_slice.write_rig), or, with --vis, the visualization render
`render_rgba_vis` on the same scene (tools/vis_slice.py; with --grad, the
gradient of its differentiable chain for a seeded random cotangent instead),
warms it up, records --steps steps with
torch.profiler (CPU and CUDA activities) and prints one JSON line: the
step's wall time (host clock around a synchronize), the device's busy time
per step (sum of kernel and memory op times on the card) and idle share,
the device ops launched per step, the peak device memory of the recorded
steps, and the --top device ops by time per step. The profiler's own cost
is in the wall time; the device times are the card's. For a train step it
turns the program's spans on (util/profiling.py) and also reports a
section for each span of the render (RENDER_SPANS, ops/render.py): the
device ms, device ops and top-level host ops inside it and in the
backward of every op created there (autograd's nodes with those sequence
numbers). And it records one more step with
shapes and counts the zero fills (`aten::zero_`, which `aten::zeros`
calls) and in-place adds (`aten::add_`) on any per-pixel tensor, (B, c, H,
W) or (B, H, W, c), with their device time: among them the fused
interpolation's per-pixel outputs, whose cotangents autograd materializes
and sums where the render slices one buffer; and the ops with a tap tensor
(B, 4 or 8, H * W) among their inputs, which the fused sampler never forms.

Run as a script with an older tree of the port first on PYTHONPATH, it
profiles that tree the same way; a tree without spans reads empty render
sections.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from vhap_tpu_torch.util import profiling


def _eval_step():
    from vhap_tpu_torch.tools.eval_slice import build_eval_slice
    s = build_eval_slice(device="cuda")
    energy = s.make_energy(True)

    def step():
        with torch.no_grad():
            energy(s.params, s.batch)
    return step, int(s.batch["rgb"].shape[0])


def buffer_ops(step, B: int, H: int, W: int, events=None):
    """Run step() once under torch.profiler with shapes recorded (or read
    `events` of such a run); return {"<op> <shape>": {"calls",
    "device_ms"}} for the zero fills and in-place adds whose first input is
    a per-pixel tensor: (B, c, H, W) or (B, H, W, c), any c."""
    if events is None:
        events = shaped_events(step)
    out = {}
    for ev in events:
        shape = ev.input_shapes[0] if ev.input_shapes else []
        if (ev.name in ("aten::zero_", "aten::add_") and len(shape) == 4
                and shape[0] == B and [H, W] in (shape[1:3], shape[2:])):
            row = out.setdefault(f"{ev.name} {tuple(shape)}",
                                 {"calls": 0, "device_ms": 0.0})
            row["calls"] += 1
            row["device_ms"] += ev.device_time_total / 1e3
    return out


RENDER_SPANS = ("render.raster", "render.interp", "render.texture",
                "render.disturb", "render.antialias")


def span_section(events, name: str, steps: int):
    """Per step: device ms, device ops and top-level host ops of the
    program's span `name` (util/profiling.py), forward (the ops inside its
    ranges) and backward (autograd's evaluate_function events whose
    sequence number is one of an op created in those ranges). Device ms
    sum the ops launched inside, not the range's own span on the device
    timeline (a user annotation)."""
    from torch.autograd import DeviceType
    seqs = set()

    def walk(ev, tally, forward):
        if forward and ev.sequence_nr >= 0:
            seqs.add(ev.sequence_nr)
        for k in ev.kernels:
            if k.name != name:
                tally["device_ms"] += k.duration / 1e3
                tally["device_ops"] += 1
        for ch in ev.cpu_children:
            walk(ch, tally, forward)

    def host_op(ev):
        return not ev.name.startswith(("cuda", "Memcpy", "Memset"))

    fwd = {"device_ms": 0.0, "device_ops": 0, "host_ops": 0}
    for ev in events:
        if ev.name == name and ev.device_type == DeviceType.CPU:
            walk(ev, fwd, True)
            fwd["host_ops"] += sum(map(host_op, ev.cpu_children))
    bwd = {"device_ms": 0.0, "device_ops": 0, "host_ops": 0}
    for ev in events:
        if ev.name.startswith("autograd::engine::evaluate_function:") and \
                ev.sequence_nr in seqs:
            walk(ev, bwd, False)
            bwd["host_ops"] += 1
    return {k: {n: v / steps for n, v in d.items()}
            for k, d in (("forward", fwd), ("backward", bwd))}


def tap_tensor_ops(events, B: int, P: int):
    """{op name: calls} of the ops with a (B, 4, P) or (B, 8, P) input
    (trilinear taps written out), from a profile with shapes."""
    out = {}
    for ev in events:
        if any(len(sh) == 3 and sh[0] == B and sh[1] in (4, 8) and sh[2] == P
               for sh in ev.input_shapes or []):
            out[ev.name] = out.get(ev.name, 0) + 1
    return out


def shaped_events(step):
    """The events of one step() under torch.profiler, shapes recorded."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step()
    return prof.events()


def _train_step(stage: str, multiview=None):
    if multiview is not None:
        from vhap_tpu_torch.tools.multiview_slice import build_multiview_slice
        ts = build_multiview_slice(multiview, device="cuda", stage=stage)
    else:
        from vhap_tpu_torch.tools.train_slice import build_train_slice
        ts = build_train_slice(device="cuda", stage=stage)
    init, step_fn = ts.make_step(True, True)
    state = {"params": ts.eval.params}
    state["opt"] = init(state["params"])
    gen = ts.generator(0)

    def step():
        state["params"], state["opt"], _, _ = step_fn(
            state["params"], state["opt"], ts.eval.batch, gen)
    return step, int(ts.eval.batch["rgb"].shape[0]), ts.eval.image_size


def _vis_step(grad: bool):
    from vhap_tpu_torch.tools.vis_slice import build_vis_slice
    vs = build_vis_slice(device="cuda")
    B = int(vs.verts.shape[0])
    if not grad:
        return lambda: vs.render(True), B
    gen = torch.Generator(device="cuda").manual_seed(0)
    cot = torch.randn((B,) + tuple(vs.image_size) + (4,), generator=gen,
                      device="cuda")

    def step():
        verts = vs.verts.clone().requires_grad_(True)
        tex = vs.tex.clone().requires_grad_(True)
        torch.autograd.grad(vs.grad_loss(verts, tex, cot), (verts, tex))
    return step, B


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", default=None,
                    help="a training stage of cfg.pipeline (default: the eval step)")
    ap.add_argument("--vis", action="store_true",
                    help="the visualization render (render_rgba_vis)")
    ap.add_argument("--grad", action="store_true",
                    help="with --vis: the gradient of the vis chain")
    ap.add_argument("--multiview", default=None, metavar="ROOT",
                    help="with --stage: the calibrated step on the rig at ROOT")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval: no CUDA device; it profiles the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if args.grad and not args.vis:
        raise SystemExit("profile_eval: --grad goes with --vis")
    if args.multiview and not args.stage:
        raise SystemExit("profile_eval: --multiview goes with --stage")
    if args.vis:
        run, batch = _vis_step(args.grad)
        name = "vis_grad" if args.grad else "vis"
    elif args.stage:
        run, batch, (H, W) = _train_step(args.stage, args.multiview)
        name = args.stage + (" (multiview)" if args.multiview else "")
    else:
        run, batch = _eval_step()
        name = "eval"

    def step():
        run()
        torch.cuda.synchronize()

    train = bool(args.stage and not args.vis)
    enable_spans = getattr(profiling, "enable_spans", None)   # an older tree has none
    if train and enable_spans is not None:
        enable_spans(True)
    for _ in range(3):
        step()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    if enable_spans is not None:
        enable_spans(False)
        span_names = {sp.name for sp in profiling.take_spans()}
    else:
        span_names = set()
    peak = torch.cuda.max_memory_allocated()

    rows = []
    for ev in prof.key_averages():
        # a profiler range shows on the device timeline as a user
        # annotation spanning its ops; it is no device op of its own
        if ev.device_type != torch.autograd.DeviceType.CUDA or \
                ev.key in span_names or getattr(ev, "is_user_annotation", False):
            continue
        ms = ev.self_device_time_total / 1e3 / args.steps
        rows.append({"name": ev.key[:120], "calls_per_step": ev.count / args.steps,
                     "ms_per_step": ms})
    launches = sum(r["calls_per_step"] for r in rows)
    rows.sort(key=lambda r: -r["ms_per_step"])
    busy = sum(r["ms_per_step"] for r in rows)
    for r in rows:
        r["share"] = r["ms_per_step"] / busy if busy else None
    extra = {}
    if train:
        events = prof.events()
        extra["render_sections_per_step"] = {
            name: span_section(events, name, args.steps) for name in RENDER_SPANS}
        events = shaped_events(step)
        extra["pixel_buffer_ops_per_step"] = buffer_ops(step, batch, H, W, events)
        extra["tap_tensor_ops_per_step"] = tap_tensor_ops(events, batch, H * W)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "card": smi, "step": name, "steps": args.steps,
        "batch": batch, "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy if rows else "not measured",
        "device_idle_share": 1.0 - busy / wall_ms if rows else "not measured",
        "device_ops": len(rows),
        "device_launches_per_step": launches if rows else "not measured",
        "peak_memory_gib": peak / 2**30, **extra, "top": rows[:args.top]}))


if __name__ == "__main__":
    main()
