"""The denoiser call replayed as a CUDA graph.

``pipeline.model_function`` hands the sampler a ``DenoiserCall``: the
ControlLDM at a control strength, on a request's hoisted tables. Where the
call's input shows that a graph is safe, it runs through the model's
``DenoiserGraphs``: captured once per signature, then replayed. A replay
copies the call's inputs into the graph's static inputs and issues one
graph launch in place of the ~3860 kernel launches of UNet + IRControlNet;
the kernels, their order and their precision are those of the eager call,
every hand-written one (K1, K3, K4, K6, K7) included.

When a graph is safe (every other call runs eagerly, as before): the model
is a ``ControlLDM`` that is not split across processes (tensor parallelism
shards it, spatial parallelism wraps it: their collectives cannot be
captured), ``x`` is on a CUDA device and autograd is off. The tiled and
turbo model functions are other callables and never come here.

The signature (what a graph bakes in): the shapes and dtypes of ``x`` and
the condition, the hoisting (none, the context k/v, or the k/v and the
timestep tables), the control strength, and the model's state: its
``version`` (which ``set_mode`` and the other setters, and the
quantisations bump; read at every call) and the address and version of
every UNet and ControlNet parameter and buffer (weights loaded, moved or
updated; taken once per request, and again when the version moves). A
call in another state drops every graph of the old one, so a stale graph
never replays.

The static inputs: ``x``, the [rows] timestep vector (filled on the device
from the host value), the condition (``c_txt``, ``c_img``; copied once per
request), the context k/v (moved in once per request: the request's tables
then point at them, so one copy stays alive) and a step's timestep rows
(one copy from the request's packed tables, ``HoistTables.packed``). One
set of flat buffers, grown to the largest signature, serves every graph of
a model through views; growing it captures the model's graphs again. A
model keeps the graphs of its ``MAX_GRAPHS`` last used signatures. The
graphs share one private memory pool and are replayed one at a time, under
a lock, each output copied out before the next replay. A signature's first
call is a warm-up call on a side stream, whose output it returns, then the
capture on the same stream (so that the graph adds one cuBLAS workspace),
recorded in ``thread_local`` mode so that other threads' CUDA calls cannot
break it; its later calls are replays. Graphs dropped in a call (stale
ones, or those captured again on grown buffers) live until its captures
are done, so that the pool always has a graph that holds it and is never
made anew. A capture neither synchronises the device nor empties the
allocator's cache (as ``torch.cuda.graph`` does): it comes in the middle
of traffic wherever a request brings a new signature.

The storage holds one request's condition and k/v at a time: a call of
another request while its ``DenoiserCall`` is alive runs eagerly.

``DenoiserCall.graph`` says what its last call did: ``EAGER``, ``CAPTURE``
or ``REPLAY`` (the ``model.call`` span's ``graph`` attribute).
``CudaKernel.launches`` counts what the device runs: a capture adds
nothing (its warm-up call counts as an eager one; ``_cuda.capture_tally``),
a replay the graph's recorded launches.
"""

from __future__ import annotations

import itertools
import threading
import weakref
from collections import OrderedDict
from typing import Mapping, NamedTuple, Optional

import torch
import torch.distributed as dist

from ..ops import _cuda
from ..sampler.base import timestep_vector
from .cldm import ControlLDM, HoistTables

EAGER, CAPTURE, REPLAY = 0, 1, 2
MAX_GRAPHS = 8   # a model's graphs: those of its last used signatures


def split_across_processes(cldm: ControlLDM) -> bool:
    """Whether tensor parallelism has sharded the model (a unit's column
    layer carries its ``tp_group``)."""
    return (dist.is_available() and dist.is_initialized()
            and any(hasattr(m, "tp_group") for m in cldm._denoisers()))


def graph_safe(x: torch.Tensor) -> bool:
    """What a call's input must show for a graph: a CUDA tensor, autograd
    off."""
    return x.is_cuda and not torch.is_grad_enabled()


class DenoiserCall:
    """The sampler's ``model_fn(x, t, cond)`` of an untiled, uncached
    request: ``cldm`` at control scale ``strength`` on the step's [B]
    timestep vector, with the step's rows of ``tables`` when hoisting;
    replayed as a CUDA graph where that is safe (see the module's notes)."""

    def __init__(self, cldm, strength: float = 1.0, tables: Optional[HoistTables] = None):
        self.cldm, self.strength, self.tables = cldm, float(strength), tables
        self.graph = EAGER
        self.whole = isinstance(cldm, ControlLDM) and not split_across_processes(cldm)
        # the hoisted tables' ((module, width per row), ...): k/v and timestep rows
        self.kv_widths = None if tables is None else tuple(
            (m, v.shape[2]) for m, v in tables.kv.items())
        self.emb_widths = None if tables is None or tables.emb is None else tuple(
            (m, v.shape[2]) for m, v in tables.emb.items())
        self.bound_cond = None   # the condition tensors copied into the static inputs
        self._state = None

    def eager(self, x: torch.Tensor, t: float, c: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return self.cldm(x, timestep_vector(t, x), c, control_scales=self.strength,
                         hoisted=None if self.tables is None else self.tables.lookup(t))

    def __call__(self, x: torch.Tensor, t: float, c: Mapping[str, torch.Tensor]) -> torch.Tensor:
        if self.whole and graph_safe(x):
            out = graphs_of(self.cldm).call(self, x, t, c)
            if out is not None:
                return out
        self.graph = EAGER
        return self.eager(x, t, c)

    def state(self) -> tuple:
        """The model's version and every denoiser tensor's address and
        version, taken at the request's first graphed call and again
        whenever the model's version has moved."""
        if self._state is None or self._state[0] != self.cldm.version:
            cldm = self.cldm
            tensors = itertools.chain.from_iterable(
                itertools.chain(r.parameters(), r.buffers()) for r in (cldm.unet, cldm.controlnet))
            self._state = (cldm.version, tuple((p.data_ptr(), p._version) for p in tensors))
        return self._state

    def signature(self, x: torch.Tensor, c: Mapping[str, torch.Tensor]) -> "Signature":
        tables = self.tables
        return Signature(tuple(x.shape), x.dtype, tuple(c["c_img"].shape), c["c_img"].dtype,
                         tuple(c["c_txt"].shape), c["c_txt"].dtype,
                         0 if tables is None else (1 if tables.emb is None else 2),
                         None if tables is None else tables.kv[self.kv_widths[0][0]].dtype,
                         self.strength)


class Signature(NamedTuple):
    """What a graph bakes in besides the model's state."""
    x: tuple
    x_dtype: torch.dtype
    c_img: tuple
    c_img_dtype: torch.dtype
    c_txt: tuple
    c_txt_dtype: torch.dtype
    hoist: int           # 0 none, 1 the context k/v, 2 also the timestep rows
    table_dtype: Optional[torch.dtype]
    strength: float


class _Graph:
    __slots__ = ("graph", "out", "launches")

    def __init__(self, graph, out, launches):
        self.graph, self.out, self.launches = graph, out, launches


class DenoiserGraphs:
    """One model's graphs of the denoiser call, their static inputs and
    their memory pool (see the module's notes)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.buffers = {}        # name: flat tensor
        self.graphs = OrderedDict()   # Signature: _Graph, the last used last
        self.state = None
        self.kv_widths = self.emb_widths = None   # the model's, as the tables show them
        self.owner = None        # weakref to the DenoiserCall whose request the storage holds
        self.pool = self.side = self.done = None   # set at the first capture

    def call(self, dc: DenoiserCall, x: torch.Tensor, t: float,
             c: Mapping[str, torch.Tensor]) -> Optional[torch.Tensor]:
        """The call as a replay (the first call of a signature: its warm-up
        call, then the capture); None where the storage holds another live
        request's inputs (run it eagerly)."""
        with self.lock:
            owner = self.owner() if self.owner is not None else None
            if owner is not None and owner is not dc:
                return None
            stream = torch.cuda.current_stream(x.device)
            if self.done is not None:
                stream.wait_event(self.done)   # the last replay's output is copied out
            # graphs dropped in this call live on until its captures are done,
            # so that those reuse their pool (a pool no graph holds is freed)
            retired = []
            state = dc.state()
            if state is not self.state and state != self.state:
                retired.append(self.graphs)   # stale
                self.graphs = OrderedDict()
                self.state, self.kv_widths, self.emb_widths = state, None, None
            self.kv_widths = self.kv_widths or dc.kv_widths
            self.emb_widths = self.emb_widths or dc.emb_widths
            sig = dc.signature(x, c)
            grown = self._fit(sig, x.device)
            if owner is None or "kv" in grown:
                self._bind(dc, sig)
            x_in, t_in, cond_in, _ = self._inputs(sig)
            if grown or dc.bound_cond is None or not _same(dc.bound_cond, c):
                cond_in["c_txt"].copy_(c["c_txt"])
                cond_in["c_img"].copy_(c["c_img"])
                dc.bound_cond = (c["c_txt"], c["c_txt"]._version, c["c_img"], c["c_img"]._version)
            x_in.copy_(x)
            t_in.fill_(float(t))
            if sig.hoist == 2:
                packed = dc.tables.packed
                self.buffers["emb"][:packed.shape[1]].copy_(packed[dc.tables.row(t)])
            kept = [s for s in self.graphs if s != sig]   # by last use
            kept = kept[max(0, len(kept) + 1 - MAX_GRAPHS):]
            if grown:   # every graph reads the old buffers: capture them again
                retired.append(self.graphs)
                self.graphs = OrderedDict()
            entry = self.graphs.get(sig)
            if entry is None:
                entry, out = self._capture(dc.cldm, sig)
                self.graphs[sig] = entry
                dc.graph = CAPTURE
            else:
                entry.graph.replay()
                _cuda.count(entry.launches)
                out = entry.out.clone()
                dc.graph = REPLAY
            # after this call's, the largest first, so that the smaller ones fit in its pool
            for s in sorted(kept if grown else (), key=lambda s: _numel(s.x), reverse=True):
                self.graphs[s] = self._capture(dc.cldm, s, warm_up=False)[0]
            for s in (*kept, sig):
                if s in self.graphs:
                    self.graphs.move_to_end(s)
            while len(self.graphs) > MAX_GRAPHS:
                self.graphs.popitem(last=False)
            self.done.record(stream)
            return out

    def _need(self, sig: Signature) -> dict:
        """{buffer: (numel, dtype)} of a signature's static inputs."""
        rows, seq = sig.x[0], sig.c_txt[1]
        need = {"x": (_numel(sig.x), sig.x_dtype), "t": (rows, torch.float32),
                "c_img": (_numel(sig.c_img), sig.c_img_dtype),
                "c_txt": (_numel(sig.c_txt), sig.c_txt_dtype)}
        if sig.hoist:
            need["kv"] = (rows * seq * sum(w for _, w in self.kv_widths), sig.table_dtype)
        if sig.hoist == 2:
            need["emb"] = (rows * sum(w for _, w in self.emb_widths), sig.table_dtype)
        return need

    def _fit(self, sig: Signature, device) -> set:
        """Grow (with zeros) the buffers that a signature does not fit; the
        names of those that grew."""
        grown = set()
        for name, (numel, dtype) in self._need(sig).items():
            buf = self.buffers.get(name)
            if buf is None or buf.dtype != dtype or buf.numel() < numel:
                if buf is not None and buf.dtype == dtype:
                    numel = max(numel, buf.numel())
                self.buffers[name] = torch.zeros(numel, dtype=dtype, device=device)
                grown.add(name)
        return grown

    def _bind(self, dc: DenoiserCall, sig: Signature) -> None:
        """Take the storage for ``dc``'s request: move its k/v tables in."""
        self.owner = weakref.ref(dc)
        dc.bound_cond = None
        if dc.tables is not None:
            kv = self._inputs(sig)[3]
            for m, table in dc.tables.kv.items():
                kv[m].copy_(table)
            dc.tables.move_kv({m: kv[m] for m in dc.tables.kv})

    def _inputs(self, sig: Signature):
        """(x, t, cond, hoisted) of a signature: views of the buffers."""
        b, rows, seq = self.buffers, sig.x[0], sig.c_txt[1]
        cond = {"c_txt": b["c_txt"][:_numel(sig.c_txt)].view(sig.c_txt),
                "c_img": b["c_img"][:_numel(sig.c_img)].view(sig.c_img)}
        hoisted = None if sig.hoist == 0 else {}
        at = 0
        for m, w in self.kv_widths if sig.hoist else ():
            hoisted[m] = b["kv"][at: at + rows * seq * w].view(rows, seq, w)
            at += rows * seq * w
        at = 0
        for m, w in self.emb_widths if sig.hoist == 2 else ():
            hoisted[m] = b["emb"][at: at + rows * w].view(rows, w)
            at += rows * w
        return b["x"][:_numel(sig.x)].view(sig.x), b["t"][:rows], cond, hoisted

    def _capture(self, cldm: ControlLDM, sig: Signature, warm_up: bool = True):
        """(The graph of the call, the warm-up call's output): the warm-up
        runs on a side stream before the capture, as the first call of a
        signature; a capture again on grown buffers needs none (output
        None)."""
        x, t, cond, hoisted = self._inputs(sig)
        if self.side is None:
            self.side = torch.cuda.Stream(x.device)
            self.done = torch.cuda.Event()
        if self.pool is None:   # one for the model's graphs
            self.pool = torch.cuda.graph_pool_handle()

        def run():
            return cldm(x, t, cond, control_scales=sig.strength, hoisted=hoisted)

        warm = None
        if warm_up:
            current = torch.cuda.current_stream(x.device)
            self.side.wait_stream(current)
            with torch.cuda.stream(self.side):
                warm = run()
            current.wait_stream(self.side)
            warm.record_stream(current)
        graph = torch.cuda.CUDAGraph()
        try:
            with _cuda.capture_tally() as launches, torch.cuda.stream(self.side):
                graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                try:
                    out = run()
                finally:
                    graph.capture_end()
        except BaseException:
            if not self.graphs:   # the pool may go with this graph: take a new one next
                self.pool = None
            raise
        return _Graph(graph, out, launches), warm


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _same(bound, c) -> bool:
    return (bound[0] is c["c_txt"] and bound[1] == c["c_txt"]._version
            and bound[2] is c["c_img"] and bound[3] == c["c_img"]._version)


_models = weakref.WeakKeyDictionary()   # ControlLDM: DenoiserGraphs
_models_lock = threading.Lock()


def graphs_of(cldm: ControlLDM) -> DenoiserGraphs:
    """The model's graphs (made at its first graphed call; they go with the
    model)."""
    with _models_lock:
        graphs = _models.get(cldm)
        if graphs is None:
            graphs = _models[cldm] = DenoiserGraphs()
        return graphs
