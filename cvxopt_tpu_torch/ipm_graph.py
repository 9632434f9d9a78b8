"""CUDA-graph tapes of the IPM pass.

A persistent solver (`make_coneqp_cascade`, `make_coneqp`) runs its IPM
loop at the same shapes call after call.  An eager pass is some 300
small launches, each prepared in Python; on a small batch the card
waits on them.  A *tape* records one pass and replays it:

    segment 0, wrapper call, segment 1, wrapper call, ..., last segment

A segment is a `torch.cuda.CUDAGraph` of what the pass launches between
two calls into the fused-Cholesky wrappers of `ops/fused_chol.py`; all
segments of a solver's tapes share one private memory pool.  The
wrappers run eagerly, called through the module attribute with ``out=``
buffers of the tape, so that their launch counters, any spans put
around them and panel_factor's side stream behave as in an eager pass.
The last segment merges the pass into the state (an instance that was
not running keeps its own), copies the merged state into the tape's
static state and writes whether any instance still runs; the host reads
that one value a pass, as the eager loop does.

While a tape records, a wrapper call made through `call` does not run:
the tape ends the segment, notes the call and returns its out buffers.
The recorded pass is then run by replaying the whole tape once.

A tape reads its inputs at fixed addresses.  A solver passes each
input, and each value computed from the inputs that the pass reads,
through `pin`: its first call on a tape keeps a copy, later calls copy
into it.  Results are copied out of the static state before they are
handed back.

A solver asks its `Tapes` for a tape with its cache key (phase and the
inputs' shapes and dtypes).  One engages only where the device is CUDA,
the solver marks its pass capturable (a capturable kktsolver, see
`kkt.capturable`, and nothing printed) and the key was seen before: the
first call of a key runs eagerly and marks it, the second records.  So
a one-shot solve never captures, and a persistent solver captures once
per key.  A solver's tapes are state it keeps between calls, with the
memory of their inputs, state and graphs: call one solver from one
thread at a time.  Inside a replayed pass, the program's spans
(`trace`) below `cvx.ipm.replay` fire only while the tape records.

`counts()` gives the captures, the passes run from a tape (`replays`,
the recording pass included) and the eager passes of every IPM loop
since `reset_counts()`, and, of the loops given a warm start, those
that built the cold start point (`cold_starts`) and those that skipped
it because every warm start was valid (`cold_skips`).
"""

from __future__ import annotations

import gc
import threading
import warnings

import torch

from cvxopt_tpu_torch.ops import fused_chol as fc
from cvxopt_tpu_torch.trace import span
from cvxopt_tpu_torch._tree import _leaves, _tmap

COUNTS = dict.fromkeys(("captures", "replays", "eager_passes",
                        "cold_starts", "cold_skips"), 0)

_local = threading.local()


def counts():
    """Captures, tape replays, eager passes and warm-started loops'
    cold start points built and skipped since `reset_counts`."""
    return dict(COUNTS)


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def call(name, *args, **kw):
    """Call the `fused_chol` wrapper `name` through the module attribute;
    while a tape records on this thread, defer the call to the tape."""
    tape = getattr(_local, "tape", None)
    if tape is not None:
        return tape.defer(name, args, kw)
    return getattr(fc, name)(*args, **kw)


def pin(tape, name, value, dtype=None):
    """`value` (cast to `dtype`) at the tape's fixed address for `name`;
    without a tape, `value` cast."""
    if tape is None:
        return value if dtype is None else value.to(dtype)
    return tape.pin(name, value, dtype)


def once(tape, name, make):
    """`make()`, built once per tape (on every call without one)."""
    if tape is None:
        return make()
    if name not in tape.objs:
        tape.objs[name] = make()
    return tape.objs[name]


class Tapes:
    """One solver's tapes, one per cache key, in one memory pool."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.graphs = self.device.type == "cuda"
        self.seen = set()
        self.tapes = {}
        self._pool = self._stream = None

    def get(self, phase, tensors, capturable):
        """The tape for `phase` at the shapes and dtypes of `tensors`, or
        None where none engages (see the module's docstring)."""
        if not (self.graphs and capturable):
            return None
        key = (phase,) + tuple((tuple(t.shape), t.dtype) for t in tensors)
        if key not in self.seen:
            self.seen.add(key)
            return None
        if key not in self.tapes:
            self.tapes[key] = Tape(self)
        return self.tapes[key]

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def stream(self):
        """The side stream the tapes capture on."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream


class Tape:
    """One IPM pass as graph segments and deferred wrapper calls."""

    def __init__(self, owner):
        self.owner = owner
        self.bufs = {}         # pinned inputs and values
        self.objs = {}         # `once`
        self.state = None      # the static state
        self.more = None       # whether any instance still runs
        self.parts = None      # CUDAGraphs and (wrapper, args, kwargs)
        self._graph = None     # the segment being captured

    def pin(self, name, value, dtype=None):
        buf = self.bufs.get(name)
        if buf is None:
            buf = self.bufs[name] = value.to(dtype or value.dtype,
                                             copy=True)
        else:
            buf.copy_(value)
        return buf

    def run(self, st, step, more, syncs):
        """The IPM loop from state `st`: each pass is `step` (a state ->
        merged state map) replayed from the tape, recorded on the first
        pass that needs it; `more(state)` says whether any instance runs.
        Each check of it counts in ``syncs[0]``.  Returns a copy of the
        final state."""
        if self.state is None:
            self.state = _tmap(torch.clone, st)
            self.more = torch.empty((), dtype=torch.bool,
                                    device=st["status"].device)
        else:
            _tmap(lambda dst, src: dst.copy_(src), self.state, st)
        self.more.copy_(more(self.state))
        while True:
            syncs[0] += 1
            with span("cvx.ipm.sync"):
                go = bool(self.more)       # the one host sync per pass
            if not go:
                return _tmap(torch.clone, self.state)
            with span("cvx.ipm.pass"):
                if self.parts is None:
                    self._record(step, more)
                with span("cvx.ipm.replay"):
                    self._replay()

    def _record(self, step, more):
        main = torch.cuda.current_stream(self.owner.device)
        side = self.owner.stream()
        side.wait_stream(main)
        self.parts = []
        _local.tape = self
        # a graph that the garbage collector frees while this tape
        # captures (another solver's tapes) ends the capture: collect
        # only after it
        collect = gc.isenabled()
        gc.disable()
        with torch.cuda.stream(side):
            try:
                self._begin()
                new = step(self.state)
                for dst, src in zip(_leaves(self.state), _leaves(new)):
                    dst.copy_(src)
                self.more.copy_(more(self.state))
                self._end()
            except BaseException:
                self._abort()
                raise
            finally:
                _local.tape = None
                if collect:
                    gc.enable()
        main.wait_stream(side)
        COUNTS["captures"] += 1

    def _begin(self):
        self._graph = torch.cuda.CUDAGraph()
        self._graph.capture_begin(pool=self.owner.pool())

    def _end(self):
        graph, self._graph = self._graph, None
        with warnings.catch_warnings():
            # two wrapper calls in a row leave a segment with no work
            warnings.filterwarnings("ignore", "The CUDA Graph is empty")
            graph.capture_end()
        self.parts.append(graph)

    def _abort(self):
        """Close a capture that failed; the tape records anew next time."""
        graph, self._graph, self.parts = self._graph, None, None
        if graph is not None:
            try:
                graph.capture_end()
            except RuntimeError:
                pass    # the capture's own error is the one raised

    def defer(self, name, args, kw):
        """Note a wrapper call in place of running it: end the segment,
        keep the call with out buffers from the pool, start the next."""
        out = fc.out_buffers(name, *args, **kw)
        self._end()
        self.parts.append((name, args, dict(kw, out=out)))
        self._begin()
        return out

    def _replay(self):
        for part in self.parts:
            if isinstance(part, tuple):
                name, args, kw = part
                getattr(fc, name)(*args, **kw)
            else:
                part.replay()
        COUNTS["replays"] += 1
