"""The tracker's train step, captured as one CUDA graph and replayed.

`graphed_train_step` wraps optim.make_train_step's eager step with the same
interface: (init_opt_state(params), step(params, opt_state, batch,
generator, lr_factor=1.0) -> (params, opt_state, E, log)), opt_state
{"count", "mu", "nu"}. The eager step launches some 3,700 operations a
step from one host thread; a replay launches them as one graph.

Where the graph engages, as the inputs show it: the parameters, the batch
and the generator on one CUDA device, and no process group or an NCCL one
(parallel/sharding.py `capturable`). The first call of a step runs eager
(the warm-up: lazy initialisation, the kernel library's build, the
allocator's blocks, under NCCL the first use of each of the step's
collectives; a stage that runs once never pays for a capture). The second
captures the whole step on a side stream -- the energy (FLAME, the render
with its kernels, the energy terms), torch.autograd.grad, the gradients'
all-reduce under a process group, and leaf-lr Adam -- and replays it to do
that step's work. Every later call whose batch has the keys, shapes and
dtypes of the captured one, whose parameters have the same leaves and
shapes and whose generator is the same object replays it. Any other call
runs the eager step: the CPU, a gloo group, a batch of another shape.

Under a process group every rank must run the same collectives in the
same order, so each rank captures or none does: the second call combines
the ranks' own verdicts in one all-reduce outside the graph (a host read,
once per capture; a declined step stays eager for good, without asking
again). The ranks' batches are padded to the same shapes
(sharding.pad_batch_to_devices), so once captured a call that does not
fit the graph raises on its rank: running eager there alone would meet
the other ranks' replayed collectives with other ones and hang until the
group's timeout. A gloo group reduces on the host (sharding.capturable),
which a graph does not record, so its steps stay eager.

The graph owns a buffer for every parameter leaf, for Adam's count and
moments and for every batch tensor; the optimizable leaves and Adam's
state in two sets. The step is
captured once from each set into the other (two graphs sharing one memory
pool), and the calls alternate: a call reads the set the previous call
wrote and writes the other, so, as the eager step, it never writes a
tensor it was given. A caller's tensor is copied into its buffer unless it
is that buffer: at a new stage, a warm start (params.copy_forward makes new
tensors), a fresh init_opt_state or a new batch. The step returns buffers:
the parameters and Adam state it wrote and the frozen leaves' buffers,
which hold their values until the call after next, and the graph's E and
log, which hold theirs until the next call only (the second graph's
tensors may lie in memory the first graph's replay reuses: the pool's
blocks the first capture freed).

A graph is captured from make_train_step's own `step.body`, which reads
nothing from the host: Adam's count is on the device, its bias corrections
come from a table on the device, each leaf's learning rate is a float32
device scalar (`step.learning_rates`, filled before a replay when the lr
factor changes). The disturbance's generator is registered with the
graphs, so a replay draws what the eager step would draw from the same
generator state and advances the generator as far; its saved state stays
right.

Kernel.launches counts a replay's launches too: those recorded at capture
are added again on every replay (a capture itself launches nothing). With
spans on (util/profiling.py) a graphed call is the span `step`, holding
`step.capture` (the first graphed call; the recordings open the eager
step's inner spans) and `step.replay`. A replayed step opens `step` and
`step.replay` only: step.forward, step.backward, step.adam, flame and
render.* open on eager and capturing calls alone.

A tracker holds one `StepGraphs`: one step's graphs live at a time
(capturing another step releases the previous graphs and their memory
pool), and counts of the calls run eager, captured and replayed (each call
counts once).
"""

from __future__ import annotations

import gc
import weakref
from typing import Callable, Dict, FrozenSet, Optional, Tuple

import torch

from vhap_tpu_torch.ops.kernels import Kernel
from vhap_tpu_torch.parallel import sharding
from vhap_tpu_torch.tracker import optim
from vhap_tpu_torch.util.profiling import span


class StepGraphs:
    """A tracker's graphed train steps: the one whose graphs are live, and
    the calls run eager, captured and replayed."""

    def __init__(self):
        self._live = None         # a weak reference: the caller owns its steps
        self.captures = self.replays = self.eager = 0

    @property
    def live(self) -> Optional["_GraphedStep"]:
        return self._live() if self._live is not None else None

    def counts(self) -> Dict[str, int]:
        return {"captures": self.captures, "replays": self.replays,
                "eager": self.eager}

    def hold(self, step: "_GraphedStep") -> None:
        """`step` captures next: release the graphs another step holds."""
        live = self.live
        if live is not None and live is not step:
            live.release()
        self._live = weakref.ref(step)


def graphed_train_step(energy_fn: Callable, opt_leaves: FrozenSet[str],
                       lr_map: Dict[str, float], lr_scale: float = 1.0,
                       graphs: Optional[StepGraphs] = None
                       ) -> Tuple[Callable, Callable]:
    """make_train_step's (init_opt_state, step), the step replayed from
    CUDA graphs where it may be (module docstring). `graphs`: the tracker's
    StepGraphs (default: one of this step's own)."""
    step = _GraphedStep(energy_fn, opt_leaves, lr_map, lr_scale,
                        graphs if graphs is not None else StepGraphs())
    return step.init_opt_state, step


def _signature(tensors: Dict) -> Optional[Tuple]:
    if not all(isinstance(v, torch.Tensor) for v in tensors.values()):
        return None
    return tuple((k, v.shape, v.dtype, v.device) for k, v in sorted(tensors.items()))


class _GraphedStep:
    """The step of graphed_train_step: eager, capturing or replaying, as
    its inputs allow (module docstring)."""

    def __init__(self, energy_fn, opt_leaves, lr_map, lr_scale, graphs: StepGraphs):
        self.init_opt_state, self.eager_step = optim.make_train_step(
            energy_fn, opt_leaves, lr_map, lr_scale)
        self.opt_leaves = opt_leaves
        self.keys = sorted(opt_leaves)
        self.graphs = graphs
        self.warm = False
        self.declined = False     # the ranks agreed not to capture
        self.graph = None         # the two graphs, once captured

    def __call__(self, params, opt_state, batch, generator, lr_factor=1.0):
        if self.graph is not None:
            if self._fits(params, batch, generator):
                return self._graphed(params, opt_state, batch, lr_factor, False)
            if sharding.is_distributed():
                raise RuntimeError(
                    "the train step was captured as CUDA graphs on every rank, and this "
                    "call's parameters, batch or generator differ from the captured "
                    "ones; under a process group a rank cannot run it eager alone (its "
                    "collectives would not match the other ranks' replays)")
        elif self.warm and not self.declined and self._decide(params, batch, generator):
            self._build(params, opt_state, batch, generator)
            return self._graphed(params, opt_state, batch, lr_factor, True)
        self.warm = True
        self.graphs.eager += 1
        return self.eager_step(params, opt_state, batch, generator, lr_factor)

    def _decide(self, params, batch, generator) -> bool:
        """Whether to capture now: this process's verdict, and under a
        process group every rank's (module docstring)."""
        mine = self._may_capture(params, batch, generator)
        if not sharding.is_distributed():
            return mine
        agreed = sharding.all_agree(mine)
        self.declined = not agreed
        return agreed

    @staticmethod
    def _may_capture(params, batch, generator) -> bool:
        sig = (_signature(params), _signature(batch))
        if None in sig or generator is None or not sharding.capturable():
            return False
        devices = {s[3] for part in sig for s in part}
        if len(devices) != 1:
            return False
        dev, gen = devices.pop(), generator.device
        return (dev.type == gen.type == "cuda"
                and dev.index == (gen.index if gen.index is not None
                                  else torch.cuda.current_device()))

    def _fits(self, params, batch, generator) -> bool:
        return (generator is self.generator
                and _signature(batch) == self.batch_sig
                and _signature(params) == self.param_sig)

    def _build(self, params, opt_state, batch, generator) -> None:
        """The buffers, from this call's inputs: the frozen leaves and the
        batch once, the optimizable leaves and Adam's state twice (graph i
        reads set i and writes set 1 - i, so a call never writes the
        tensors it was given)."""
        self.graphs.hold(self)
        self.device = next(iter(params.values())).device
        self.generator = generator
        self.param_sig, self.batch_sig = _signature(params), _signature(batch)
        self.order = list(params)
        with torch.no_grad():
            self.frozen = {k: v.clone() for k, v in params.items()
                           if k not in self.opt_leaves}
            self.batch = {k: v.clone() for k, v in batch.items()}
            self.sets = [{"params": {k: params[k].clone() for k in self.keys},
                          "count": opt_state["count"].clone(),
                          "mu": {k: opt_state["mu"][k].clone() for k in self.keys},
                          "nu": {k: opt_state["nu"][k].clone() for k in self.keys}}
                         for _ in range(2)]
        self.turn = 0             # the set the caller's inputs go to

    def _bind(self, params, opt_state, batch, lr_factor) -> None:
        """Copy into the buffers what the caller holds elsewhere."""
        s = self.sets[self.turn]
        pairs = [(params[k], buf) for k, buf in self.frozen.items()]
        pairs += [(params[k], s["params"][k]) for k in self.keys]
        pairs += [(opt_state[m][k], s[m][k]) for m in ("mu", "nu") for k in self.keys]
        pairs += [(batch[k], buf) for k, buf in self.batch.items()]
        pairs.append((opt_state["count"], s["count"]))
        for src, buf in pairs:
            if src is not buf:
                buf.copy_(src)
        self.lr = self.eager_step.learning_rates(lr_factor, self.device)

    def _capture(self) -> None:
        """Graph i: the step from buffer set i into set 1 - i. The two share
        one memory pool (they never run at once)."""
        self.graph, self.out, self.launches = [], [], []
        pool = None
        # a graph freed by the garbage collector while another is captured
        # invalidates that capture: collect now, and not during the captures
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            for src, dst in ((self.sets[0], self.sets[1]), (self.sets[1], self.sets[0])):
                before = [(kern, kern.launches) for kern in Kernel.made]
                graph = torch.cuda.CUDAGraph()
                graph.register_generator_state(self.generator)
                # thread_local: the prefetch and media threads go on with
                # their own CUDA calls while the main thread captures
                with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                    _, _, E, log = self.eager_step.body(
                        {**self.frozen, **src["params"]}, src, self.batch,
                        self.generator, self.lr, out=dst)
                pool = graph.pool()
                # a capture launches nothing: its launches happen on each replay
                self.launches.append([(kern, kern.launches - n) for kern, n in before
                                      if kern.launches != n])
                for kern, n in before:
                    kern.launches = n
                self.graph.append(graph)
                self.out.append((E, log))
        finally:
            if collecting:
                gc.enable()

    def _graphed(self, params, opt_state, batch, lr_factor, capture: bool):
        with span("step"):
            with torch.no_grad():
                self._bind(params, opt_state, batch, lr_factor)
            if capture:
                with span("step.capture"):
                    self._capture()
                self.graphs.captures += 1
            else:
                self.graphs.replays += 1
            i = self.turn
            with span("step.replay"):
                self.graph[i].replay()
            for kern, n in self.launches[i]:
                kern.launches += n
        self.turn = 1 - i
        new, (E, log) = self.sets[1 - i], self.out[i]
        return ({k: self.frozen[k] if k in self.frozen else new["params"][k]
                 for k in self.order},
                {"count": new["count"], "mu": dict(new["mu"]), "nu": dict(new["nu"])},
                E, dict(log))

    def release(self) -> None:
        """Drop the graphs, their memory pool and the buffers; the next call
        captures again."""
        self.graph = self.out = self.launches = None
        self.frozen = self.batch = self.sets = None
