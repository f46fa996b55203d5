"""Operation census of a stage callable: the cost model's FLOP and byte
counts, and the collectives it issues.

The reference compiles a stage with XLA and parses the optimized HLO text
(``repro.core.hlo_analysis``); PyTorch runs eagerly, so the port counts the
operators a stage dispatches instead. ``stage_census(fn, *args)`` runs
``fn`` once under a ``TorchDispatchMode`` (``census()`` is the same around
a block) and charges each ATen operator:

- ``flops``: 2*M*N*K for the matrix products (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``);
- ``ew_flops``: one per output element of every other operator but the
  collectives;
- ``hbm_bytes``: the bytes of its tensor inputs and outputs.

Views (``is_view`` operators) move no data and do no arithmetic, so they
count nothing. These are the three fields ``StageCost.from_analysis``
reads. The kernels' custom ops (``repro_torch::...``, ``kernels/``) are
charged their bytes in and out and no element-wise FLOPs; the flash
forward adds its attended (query, key) pairs x 4 x dh to ``flops``
(``flash_flops``, the formula of its bound), on the card and, through its
fake implementation, on ``meta`` alike.

``ops`` counts every operator dispatched, views too, by name (the
reference's ``op_census`` counts HLO instructions by opcode), so two
censuses compare operator by operator. ``peak_bytes`` is the peak of the
bytes held by live storages during the block, each storage counted once
(views share one): the storages of ``census(args=...)``'s tensors from the
start (``arg_bytes``), and every storage an operator creates while it is
alive (a weak reference drops it when freed). A storage first met as an
operator's input is older than the block and not counted. What an
operator's card implementation allocates beneath the dispatcher for the
length of the call no mode sees; the two that matter on the LM's path
(``_scratch_bytes``) are charged as a spike at the call, so a ``meta``
run predicts the card's peak, before the caching allocator's rounding.

Collectives (the ``c10d`` operators ``torch.distributed`` dispatches) are
the census's other half (``parse_collectives``, ``collective_summary``);
what a backend dispatches itself to complete one, in ``Work.wait``, is
not counted.
Each is charged the reference's per-rank wire bytes, with R the size of
its process group and f = (R - 1) / R: all-reduce 2 in f, all-gather
out f, reduce-scatter and all-to-all in f, anything else in. An operator
is cross-pod when its group's ranks fall in more than one pod of
``pod_size`` ranks (``launch/mesh.py::pod_size``; 0 means one pod). The
reference multiplies a ``while`` body's counts by its trip count (its
layers and micro-batches run under ``lax.scan``); the port runs eagerly,
so every layer and micro-batch is dispatched and counted where it runs,
and ``mult`` stays 1.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from collections import Counter, defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_aten = torch.ops.aten
_MATMULS = {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm}
# c10d operator name -> the reference's collective name
_COLLECTIVES = (("allreduce", "all-reduce"), ("allgather", "all-gather"),
                ("reduce_scatter", "reduce-scatter"),
                ("alltoall", "all-to-all"))
_OUT_ARGS = ("output", "output_tensor", "output_tensors", "outputs")


@dataclasses.dataclass
class Collective:
    """One collective a stage issued."""

    op: str                     # "all-reduce", ..., or the c10d name
    wire_bytes: float           # per rank, by the formulas above
    payload_bytes: float        # the larger of its inputs and outputs
    group_size: int
    cross_pod: bool
    mult: float                 # times issued (1: eager, no loops to unroll)
    line: str                   # the c10d operator and its tensors' device


@dataclasses.dataclass
class OpCensus:
    """Counts over every operator one call of a stage dispatched."""

    flops: float = 0.0         # matrix-product (and flash) FLOPs
    ew_flops: float = 0.0      # one per output element of the other ops
    hbm_bytes: float = 0.0     # tensor bytes in + out
    collectives: list = dataclasses.field(default_factory=list)
    ops: Counter = dataclasses.field(default_factory=Counter)  # by name
    arg_bytes: int = 0         # storages of ``args``, live from the start
    peak_bytes: int = 0        # arg_bytes + the peak of those made inside

    def summary(self) -> dict:
        """The reference's ``HLOAnalysis.summary`` keys (per device: this
        rank's) and the counts by operator."""
        cs = collective_summary(self)
        return {"flops_per_device": self.flops,
                "ew_flops_per_device": self.ew_flops,
                "hbm_bytes_per_device": self.hbm_bytes,
                "coll_wire_intra_per_device": cs["bytes_intra_pod"],
                "coll_wire_cross_per_device": cs["bytes_cross_pod"],
                "coll_count": cs["count"],
                "op_count": sum(self.ops.values()),
                "coll_by_op": cs["by_op"],
                "ops": dict(sorted(self.ops.items()))}


def attended_pairs(S: int, window: int) -> float:
    """(query, key) pairs the causal (and window) mask keeps in a row
    block of ``S`` positions."""
    if not window or window >= S:
        return S * (S + 1) / 2
    return window * (window + 1) / 2 + (S - window) * window


def flash_flops(q, window: int) -> float:
    """The flash forward's FLOPs on q [B,S,H,dh]: two products of dh a
    pair, attended pairs x 4 x dh for every (batch, head)."""
    B, S, H, dh = q.shape
    return 4.0 * B * H * dh * attended_pairs(S, window)


def _scratch_bytes(name: str, args) -> int:
    """Bytes the card's implementation of operator ``name`` allocates
    beneath the dispatcher for the length of the call, which no dispatch
    mode sees (measured by ``scripts/torch_hidden_alloc.py``; ops under
    1 MiB not listed): ``_softmax_backward_data`` with a non-contiguous
    gradient copies it contiguous and computes into a contiguous buffer
    it then copies into the output's layout (two of the gradient's size);
    ``logsumexp`` holds ``input - max`` (one of the input's)."""
    if name == "aten::_softmax_backward_data":
        g = args[0]
        return 0 if g.is_contiguous() else 2 * g.numel() * g.element_size()
    if name == "aten::logsumexp":
        return args[0].numel() * args[0].element_size()
    return 0


class _Live:
    """Bytes of the live storages the block allocated (module docstring)."""

    def __init__(self, args):
        # reentrant: a collection inside ``add`` runs ``_drop`` on this
        # thread while it holds the lock
        self.lock = threading.RLock()
        self.held: dict = {}            # id(storage) -> (weakref, nbytes)
        self.older: dict = {}           # id(storage) -> weakref, uncounted
        self.now = self.peak = 0
        for t in _flat(args, []):
            self.add(t.untyped_storage())
        self.base = self.peak = self.now

    def _drop(self, key, n):
        with self.lock:
            if self.held.pop(key, None) is not None:
                self.now -= n

    def add(self, st) -> None:
        key = id(st)
        if key in self.held or key in self.older:
            return
        n = st.nbytes()
        with self.lock:
            self.held[key] = (weakref.ref(
                st, lambda _, key=key, n=n: self._drop(key, n)), n)
            self.now += n
            self.peak = max(self.peak, self.now)

    def spike(self, n: int) -> None:
        """``n`` bytes held for the length of one operator."""
        with self.lock:
            self.peak = max(self.peak, self.now + n)

    def seen(self, st) -> None:
        key = id(st)
        if key not in self.held and key not in self.older:
            self.older[key] = weakref.ref(
                st, lambda _, key=key: self.older.pop(key, None))


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _flat(x, out: list) -> list:
    """The tensors in an operator's arguments or results, or in a step's
    (tuples, lists and dicts of them; a module's parameters and buffers):
    ``_tensors`` without the pytree machinery, which costs more than a
    ``meta`` operator itself."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, torch.nn.Module):
        out.extend(x.parameters())
        out.extend(x.buffers())
    elif isinstance(x, (tuple, list)):
        for v in x:
            _flat(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _flat(v, out)
    return out


def tensors_of(x) -> list:
    """Every tensor in ``x`` (tensors, a module's parameters and buffers,
    in tuples, lists and dicts), in order, views and repeats included."""
    return _flat(x, [])


def _nbytes(tree) -> float:
    return float(sum(t.numel() * t.element_size() for t in _tensors(tree)))


def _matmul_flops(packet, args) -> float:
    """2*M*N*K for mm/addmm ([M,K] x [K,N]) and bmm/baddbmm (times B)."""
    a, b = (args[0], args[1]) if packet in (_aten.mm, _aten.bmm) \
        else (args[1], args[2])
    batch = a.shape[0] if a.dim() == 3 else 1
    return 2.0 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]


def _collective(func, args, kwargs, pod_size: int) -> Collective:
    """Charge one c10d operator: its inputs and outputs by argument name,
    its group's size and ranks from its ``process_group`` argument."""
    import torch.distributed as dist
    named = dict(zip((a.name for a in func._schema.arguments), args))
    named.update(kwargs or {})
    ranks = dist.get_process_group_ranks(
        dist.ProcessGroup.unbox(named["process_group"]))
    out_b = _nbytes([v for k, v in named.items() if k in _OUT_ARGS])
    in_b = _nbytes([v for k, v in named.items() if k not in _OUT_ARGS])
    name = func._schema.name.split("::")[-1]
    op = next((ref for key, ref in _COLLECTIVES if key in name), name)
    R = max(len(ranks), 1)
    f = (R - 1) / R
    wire = {"all-reduce": 2.0 * in_b * f, "all-gather": out_b * f,
            "reduce-scatter": in_b * f, "all-to-all": in_b * f}.get(op, in_b)
    cross = (len({r // pod_size for r in ranks}) > 1) if pod_size else False
    devices = sorted({t.device.type for t in _tensors(args)})
    return Collective(op, wire, max(in_b, out_b), R, cross, 1.0,
                      f"{name} {','.join(devices)}")


class _Census(TorchDispatchMode):
    def __init__(self, pod_size: int = 0, args=()):
        super().__init__()
        self.census = OpCensus()
        self.pod_size = pod_size
        self.live = _Live(args)
        self.composite: dict = {}       # operator -> has a decomposition

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        # under inference mode a composite operator (einsum, reshape, to)
        # reaches the mode whole: count what it decomposes into, as
        # outside inference mode
        composite = self.composite.get(func)
        if composite is None:
            composite = self.composite[func] = \
                torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(), "CompositeImplicitAutograd")
        if composite:
            with self:
                r = func.decompose(*args, **(kwargs or {}))
            if r is not NotImplemented:
                return r
        ins = _flat(kwargs, _flat(args, [])) if kwargs else _flat(args, [])
        live = self.live
        for t in ins:
            live.seen(t.untyped_storage())
        out = func(*args, **(kwargs or {}))
        c = self.census
        name = func.name()
        c.ops[name] += 1
        if func.is_view:
            return out
        outs = _flat(out, [])
        for t in outs:
            live.add(t.untyped_storage())
        live.spike(_scratch_bytes(name, args))
        c.hbm_bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        if func.namespace == "c10d":
            c.collectives.append(_collective(func, args, kwargs,
                                             self.pod_size))
        elif func.namespace == "repro_torch":
            if name == "repro_torch::flash_attention_fwd":
                c.flops += flash_flops(args[0], args[4])
        elif func.overloadpacket in _MATMULS:
            c.flops += _matmul_flops(func.overloadpacket, args)
        else:
            c.ew_flops += sum(t.numel() for t in outs)
        return out


_WAITS = {"depth": 0, "wait": None}
_WAITS_LOCK = threading.Lock()


@contextlib.contextmanager
def _backend_waits_uncounted():
    """While any census is open, a collective's ``Work.wait`` runs with the
    dispatch modes off: what a backend dispatches to complete a collective
    (gloo's reduce-scatter splits its buffer and copies the rank's block
    out in ``wait``; NCCL and the fake group dispatch nothing) is not the
    step's, and would make one step's census differ by backend."""
    try:
        from torch._C._distributed_c10d import Work
    except ImportError:                  # a build without distributed
        yield
        return
    from torch.utils._python_dispatch import _disable_current_modes
    with _WAITS_LOCK:
        if _WAITS["depth"] == 0:
            orig = _WAITS["wait"] = Work.wait

            def wait(self, *args, **kwargs):
                with _disable_current_modes():
                    return orig(self, *args, **kwargs)
            Work.wait = wait
        _WAITS["depth"] += 1
    try:
        yield
    finally:
        with _WAITS_LOCK:
            _WAITS["depth"] -= 1
            if _WAITS["depth"] == 0:
                Work.wait = _WAITS["wait"]


@contextlib.contextmanager
def census(*, pod_size: int = 0, args=()):
    """Count what the block dispatches on this thread (and on the autograd
    engine's threads it drives). ``args``: tensors (any tree of them) live
    from the start (tensors, modules' parameters and buffers, in tuples,
    lists and dicts), counted in ``arg_bytes`` and ``peak_bytes``. -> its
    ``OpCensus`` (filled when the block ends)."""
    mode = _Census(pod_size, args)
    try:
        with _backend_waits_uncounted(), mode:
            yield mode.census
    finally:
        mode.census.arg_bytes = mode.live.base
        mode.census.peak_bytes = mode.live.peak


def stage_census(fn, *args, pod_size: int = 0) -> OpCensus:
    """Run ``fn(*args)`` once and count what it dispatched."""
    with census(pod_size=pod_size) as c:
        fn(*args)
    return c


def parse_collectives(c: OpCensus) -> list:
    """The collectives of a census, in the order they were issued."""
    return list(c.collectives)


def collective_summary(c: OpCensus) -> dict:
    """The reference's ``collective_summary`` keys: the count, the wire
    bytes in all, inside a pod and across pods, and by operator."""
    by_op: dict[str, float] = defaultdict(float)
    intra = cross = 0.0
    for col in c.collectives:
        by_op[col.op] += col.wire_bytes
        if col.cross_pod:
            cross += col.wire_bytes
        else:
            intra += col.wire_bytes
    return {"count": len(c.collectives), "bytes_total": intra + cross,
            "bytes_intra_pod": intra, "bytes_cross_pod": cross,
            "by_op": dict(by_op)}
