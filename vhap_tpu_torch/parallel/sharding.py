"""Batch-axis data parallelism: one process per device.

Counterpart of vhap_tpu/parallel/sharding.py. The one parallel axis is the
batch: the frames of a monocular batch or the views of one NeRSemble
timestep. The JAX package shards it over a 1-D mesh and lets GSPMD insert
the reductions; here each device runs its own process (`torch.distributed`:
NCCL between CUDA cards, gloo on the CPU or for several processes on one
card), and the reductions are explicit:

  * the batch is padded to a multiple of the process count with weight-0
    rows (`pad_batch_to_devices`) and cut into contiguous blocks, rank r
    holding rows [r * B / n, (r + 1) * B / n) (`shard_batch`, as
    `P("data")` partitions them);
  * parameters and Adam's state are replicated (`replicate_tree` broadcasts
    them from rank 0), and every rank renders and differentiates its own
    rows through the same kernels as one process does;
  * the energy is built so that the ranks' energies sum to the whole
    batch's (tracker/energy.py: global normalizers), so one all-reduce of
    the gradients before Adam (`all_reduce_grads`) gives every rank the
    batch's gradient, and the replicas stay bit-identical.

The collectives carry no gradient and are written with `all_reduce` and
`broadcast` only, the two that gloo also runs on CUDA tensors: a gather is
an all-reduce of a zero-filled buffer in which each rank writes its own
slot (exact: x + 0 = x). Without a process group each helper is the
identity, so a one-process run is unchanged.

Under NCCL a train step's collectives (the gradient bucket, the
disturbance pool's keys, reg_diffuse's max, the energy's normalizers) run
inside the step's CUDA graphs (tracker/step_graph.py). PyTorch's notes on
CUDA graphs with NCCL ask for three things:
  * NCCL 2.9.6 or later, the first that captures collectives (PyTorch's
    CUDA builds ship a later one);
  * a communicator warmed before the capture: `init` passes the card,
    which forms the communicator at once, and a step's first call runs
    eager, so each of its collectives is used once before the capture
    (NCCL connects peers for a collective at its first use);
  * no watchdog query of work recorded in a capture, which the notes get
    by turning asynchronous error handling off. PyTorch 2.11 keeps
    captured work out of its watchdog (the sharded step captures and
    replays with the handling on, PERF.md), and the capture's thread_local
    mode leaves the watchdog's queries of eager work legal, so the
    handling stays on, and with it the abort of a collective that
    outlasts the group's timeout.
With spans on (util/profiling.py) each collective is the span
`sharding.all_reduce`; the collectives of the last train step run eager or
captured are counted by the label their caller gives (`step_collectives`).

`launch` spawns one worker per device and fails when any worker fails.
A run under `torchrun` (RANK / WORLD_SIZE set) joins its group through
`init_from_env`.
"""

from __future__ import annotations

import collections
import contextlib
import os
import pickle
import shutil
import sys
import tempfile
import threading
import time
import traceback
from datetime import timedelta
from multiprocessing import connection, get_context
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vhap_tpu_torch.util.profiling import span

BATCH_AXIS = "data"


def is_distributed() -> bool:
    """Whether this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if is_distributed() else 0


# ---------------------------------------------------------------------------
# the process group
# ---------------------------------------------------------------------------

def init(backend: str, rank_: int, world_: int, init_method: str,
         timeout: Optional[float] = None, device=None) -> None:
    """Join a process group. NCCL needs `device`, this process's card; a
    failing NCCL initialisation raises (there is no fallback to gloo)."""
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = timedelta(seconds=timeout)
    if backend == "nccl":
        if device is None or torch.device(device).type != "cuda":
            raise ValueError(f"NCCL needs a CUDA device, got {device}")
        kwargs["device_id"] = torch.device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank_,
                            world_size=world_, **kwargs)


def capturable() -> bool:
    """Whether this process's collectives may run inside a CUDA graph
    (module docstring): without a process group, or under NCCL. Gloo
    reduces on the host (it copies a CUDA tensor out, sums it on CPU
    threads and copies it back), which a graph of device work cannot
    record: its steps stay eager."""
    return not is_distributed() or dist.get_backend() == "nccl"


def from_torchrun() -> bool:
    """Whether the environment is a torchrun worker's."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_from_env(device=None, timeout: Optional[float] = None) -> torch.device:
    """Join torchrun's process group (env://): NCCL on the card LOCAL_RANK,
    or gloo when `device` is the CPU. Returns this process's device."""
    if device is not None and torch.device(device).type == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass device='cpu' to run "
                               "on the CPU")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        backend = "nccl"
    init(backend, int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
         "env://", timeout, dev)
    return dev


def shutdown() -> None:
    if is_distributed():
        dist.destroy_process_group()


def plan(num_devices: int, device=None) -> Tuple[List[str], str]:
    """(devices, backend) for `exp.num_devices` (vhap_tpu/tracker/tracker.py:
    149-151): on the CUDA cards (device None or CUDA) 0 means every visible
    card and n means min(n, cards), with NCCL; on the CPU (asked for with
    device 'cpu') 0 and 1 mean one process and n > 1 means n gloo
    processes. Without a card and without the CPU asked for, this raises."""
    if device is not None and torch.device(device).type == "cpu":
        return ["cpu"] * max(1, num_devices), "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run on "
                           "the CPU")
    avail = torch.cuda.device_count()
    n = avail if num_devices <= 0 else min(num_devices, avail)
    if n == 1:
        return [str(torch.device(device) if device is not None else "cuda")], "nccl"
    return [f"cuda:{i}" for i in range(n)], "nccl"


def _worker(fn, rank_, world_, device, backend, init_method, timeout, tmp,
            args, num_threads):
    tmp = Path(tmp)
    try:
        if num_threads:
            torch.set_num_threads(num_threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        init(backend, rank_, world_, init_method, timeout, dev)
        result = fn(dev, *args)
        part = tmp / f"result{rank_}.part"
        with open(part, "wb") as f:
            pickle.dump(result, f)
        os.replace(part, tmp / f"result{rank_}.pkl")
        shutdown()
    except BaseException:
        (tmp / f"error{rank_}.txt").write_text(traceback.format_exc())
        sys.stderr.write(f"[rank {rank_}] " + traceback.format_exc())
        sys.exit(1)


def launch(fn: Callable, devices: Sequence, backend: str, args: Tuple = (),
           init_method: Optional[str] = None, timeout: Optional[float] = None,
           join_timeout: Optional[float] = None,
           num_threads: Optional[int] = None) -> List:
    """Run `fn(device, *args)` in one spawned process per entry of
    `devices` (rank r on devices[r]; entries may repeat, e.g. two gloo
    ranks on 'cuda:0'), each in the process group of `backend`, and return
    their return values in rank order (pickled through files).

    The rendezvous is a file in a fresh temporary directory unless
    `init_method` is given; `timeout` (seconds) bounds every collective;
    `join_timeout` bounds the whole run. When a worker exits non-zero or the
    run outlasts `join_timeout`, every worker is stopped and this raises,
    with the failing workers' tracebacks."""
    n = len(devices)
    if n < 1:
        raise ValueError("launch needs at least one device")
    ctx = get_context("spawn")
    tmp = Path(tempfile.mkdtemp(prefix="vhap_launch_"))
    init_method = init_method or (tmp / "rendezvous").as_uri()
    procs = [ctx.Process(target=_worker, name=f"rank{r}", args=(
        fn, r, n, str(devices[r]), backend, init_method, timeout, str(tmp),
        tuple(args), num_threads)) for r in range(n)]
    deadline = None if join_timeout is None else time.monotonic() + join_timeout
    try:
        for p in procs:
            p.start()
        while True:
            codes = [p.exitcode for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RuntimeError(
                    f"rank(s) {bad} of {n} exited with "
                    f"{[codes[r] for r in bad]}:\n" + _errors(tmp, bad))
            if all(c == 0 for c in codes):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{n} workers still running after "
                                   f"{join_timeout} s; stopped")
            connection.wait([p.sentinel for p in procs if p.exitcode is None],
                            timeout=0.5)
        results = []
        for r in range(n):
            with open(tmp / f"result{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.terminate()
        for p in started:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)


def _errors(tmp: Path, ranks) -> str:
    out = []
    for r in ranks:
        f = tmp / f"error{r}.txt"
        out.append(f"--- rank {r} ---\n"
                   + (f.read_text() if f.exists() else "(no traceback)"))
    return "\n".join(out)


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def pad_batch_to_devices(batch: Dict, n_devices: int) -> Dict:
    """Pad the batch axis to a multiple of `n_devices`: the padding rows
    repeat the last row and have weight 0. Returns `batch` itself when it
    already divides. Leaves are torch tensors or numpy arrays."""
    B = batch["weight"].shape[0]
    rem = (-B) % n_devices
    if rem == 0:
        return batch
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            pad = v[-1:].repeat((rem,) + (1,) * (v.dim() - 1))
            out[k] = torch.cat([v, torch.zeros_like(pad) if k == "weight" else pad])
        else:
            pad = np.repeat(v[-1:], rem, axis=0)
            out[k] = np.concatenate([v, np.zeros_like(pad) if k == "weight" else pad])
    return out


def shard_batch(batch: Dict, rank_: int, world_: int) -> Dict:
    """Rank `rank_`'s contiguous block of rows of every batch leaf
    (partitioned on axis 0; the row count divisible by `world_`)."""
    n = batch["weight"].shape[0]
    if n % world_:
        raise ValueError(f"{n} rows do not divide over {world_} ranks")
    per = n // world_
    return {k: v[rank_ * per:(rank_ + 1) * per] for k, v in batch.items()}


def shard_padded(batch: Dict, rank_: Optional[int] = None,
                 world_: Optional[int] = None) -> Dict:
    """Rank `rank_`'s rows of the batch padded to a multiple of `world_`
    (default: this process's rank and world)."""
    rank_ = rank() if rank_ is None else rank_
    world_ = world() if world_ is None else world_
    return shard_batch(pad_batch_to_devices(batch, world_), rank_, world_)


# ---------------------------------------------------------------------------
# collectives (no gradient; the identity without a process group)
# ---------------------------------------------------------------------------

def _coll_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


_tally: Optional[Dict[str, Dict[str, int]]] = None     # the step being run
_last_step: Dict[str, Dict[str, int]] = {}


@contextlib.contextmanager
def step_tally():
    """Count the collectives run inside as one train step's
    (optim.make_train_step's body: an eager step, or the recording of a
    captured one; a replay runs what its capture recorded)."""
    global _tally, _last_step
    outer, _tally = _tally, collections.defaultdict(lambda: {"calls": 0, "bytes": 0})
    try:
        yield
    finally:
        _last_step, _tally = dict(_tally), outer


def step_collectives() -> Dict[str, Dict[str, int]]:
    """The collectives of the last train step run eager or captured in this
    process: caller's label -> {"calls", "bytes"} (bytes of the buffers
    reduced); empty before the first step."""
    return {c: dict(v) for c, v in _last_step.items()}


def _all_reduce(x: torch.Tensor, op, caller: str = "other") -> torch.Tensor:
    """x, a contiguous buffer the caller has just built, reduced over ranks
    in place where it lies on the collective's device (NCCL needs the card;
    gloo reduces CUDA tensors as they are), else in a copy there; returned
    on x's device. `caller` labels it in step_collectives."""
    buf = x.detach()
    if dist.get_backend() == "nccl" and not buf.is_cuda:
        buf = buf.to(_coll_device())
    if _tally is not None:
        _tally[caller]["calls"] += 1
        _tally[caller]["bytes"] += buf.numel() * buf.element_size()
    with span("sharding.all_reduce"):
        dist.all_reduce(buf, op=op)
    return buf.to(x.device)


def all_reduce_sum(x: torch.Tensor, caller: str = "other") -> torch.Tensor:
    if not is_distributed():
        return x
    return _all_reduce(x.detach().clone(memory_format=torch.contiguous_format),
                       dist.ReduceOp.SUM, caller)


def all_gather_rows(x: torch.Tensor, caller: str = "other") -> torch.Tensor:
    """Every rank's x (the same shape everywhere) stacked along axis 0 in
    rank order: an all-reduce of a zero-filled (world, ...) buffer in which
    each rank writes its own slot."""
    if not is_distributed():
        return x
    buf = x.new_zeros((world(),) + tuple(x.shape))
    buf[rank()] = x.detach()
    buf = _all_reduce(buf, dist.ReduceOp.SUM, caller)
    return buf.reshape((-1,) + tuple(x.shape[1:]))


def all_agree(flag: bool) -> bool:
    """Whether `flag` holds on every rank: one all-reduce (MIN) of one
    integer, read on the host; `flag` itself without a process group."""
    if not is_distributed():
        return bool(flag)
    x = torch.tensor([int(bool(flag))], dtype=torch.int32, device=_coll_device())
    return bool(_all_reduce(x, dist.ReduceOp.MIN).item())


def select_rows(x: torch.Tensor, rows: Sequence[int]) -> torch.Tensor:
    """Rows `rows` of the whole batch, whose rank-local block is x (rank r
    holds rows [r * len(x), (r + 1) * len(x))), on every rank."""
    rows = [int(r) for r in rows]
    if not is_distributed():
        return x.index_select(0, torch.as_tensor(rows, device=x.device))
    lo, L = rank() * x.shape[0], x.shape[0]
    out = x.new_zeros((len(rows),) + tuple(x.shape[1:]))
    mine = [(j, r - lo) for j, r in enumerate(rows) if lo <= r < lo + L]
    if mine:
        dst, src = zip(*mine)
        out[list(dst)] = x.detach()[list(src)]
    return _all_reduce(out, dist.ReduceOp.SUM)


def broadcast_object(obj, src: int = 0):
    """rank `src`'s picklable `obj`, on every rank."""
    if not is_distributed():
        return obj
    dev = _coll_device()
    if rank() == src:
        payload = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
        n = torch.tensor([payload.numel()], dtype=torch.int64, device=dev)
    else:
        n = torch.zeros(1, dtype=torch.int64, device=dev)
    dist.broadcast(n, src)
    buf = (payload.to(dev) if rank() == src
           else torch.empty(int(n), dtype=torch.uint8, device=dev))
    dist.broadcast(buf, src)
    return pickle.loads(buf.cpu().numpy().tobytes())


def run_on_lead(fn: Callable[[], None], poll_s: float = 1.0) -> None:
    """fn() on rank 0 while the other ranks wait, however long it takes:
    rank 0 runs it on a thread and every rank all-reduces rank 0's state
    (running, done, failed) every `poll_s` seconds, so that no collective
    waits longer than that and the group's timeout holds for a long fn.
    fn issues no collective. When fn raises, rank 0 raises its error and
    the other ranks a RuntimeError. Without a process group: fn()."""
    if not is_distributed():
        fn()
        return
    errors: List[BaseException] = []
    thread = None
    if rank() == 0:
        def body():
            try:
                fn()
            except BaseException as e:
                errors.append(e)
        thread = threading.Thread(target=body, name="run_on_lead", daemon=True)
        thread.start()
    while True:
        state = 0
        if thread is not None:
            thread.join(poll_s)
            state = 0 if thread.is_alive() else 2 if errors else 1
        state = int(all_reduce_sum(torch.tensor([state], device=_coll_device()))[0])
        if state == 1:
            return
        if state == 2:
            if errors:
                raise errors[0]
            raise RuntimeError("rank 0 failed in run_on_lead")


def replicate_tree(tree: Dict[str, torch.Tensor], src: int = 0) -> Dict[str, torch.Tensor]:
    """rank `src`'s tensors on every rank (one broadcast per leaf, in key
    order); a new dict in the same order."""
    if not is_distributed():
        return tree
    out = {}
    for k in sorted(tree):
        v = tree[k].detach().clone().contiguous()
        buf = v.to(_coll_device()) if dist.get_backend() == "nccl" else v
        dist.broadcast(buf, src)
        out[k] = buf.to(v.device)
    return {k: out[k] for k in tree}


def all_reduce_grads(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The sum over ranks of every gradient: the leaves flattened in key
    order into one contiguous bucket, one all_reduce(SUM) of it in place,
    unflattened. Every rank gets the same bits. The identity without a
    process group."""
    if not is_distributed():
        return grads
    keys = sorted(grads)
    dtypes = {grads[k].dtype for k in keys}
    if len(dtypes) != 1:
        raise TypeError(f"gradients of several dtypes {dtypes}")
    flat = torch.cat([grads[k].reshape(-1) for k in keys])
    flat = _all_reduce(flat, dist.ReduceOp.SUM, "grads")
    parts = dict(zip(keys, flat.split([grads[k].numel() for k in keys])))
    return {k: parts[k].view_as(g) for k, g in grads.items()}
