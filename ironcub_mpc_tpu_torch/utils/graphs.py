"""CUDA graphs around the hand-written kernels.

:class:`Piecewise` captures one run of Python code as a chain of steps: the
PyTorch work between two kernel calls becomes one CUDA graph, and each
kernel call made through :func:`launch` stays an eager call. On replay each
graph replays on the current stream and each kernel is called again through
its module attribute, looked up at the call (a wrapper swapped in after the
capture is the one called), its outputs copied into the tensors the capture
handed to the next graph. Code that runs eagerly calls :func:`launch` too,
and then it is a plain call.

:class:`StaticInputs` holds the device buffers a capture reads its inputs
from; :class:`FlatOutputs` lays a capture's outputs out in one flat buffer
a dtype, which a replay hands out as one clone a dtype.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_recording = threading.local()
ALIGN = 16   # bytes: each tensor of a flat buffer starts on a 16-byte line


def launch(module, name: str, *args, **kwargs):
    """``getattr(module, name)(*args, **kwargs)``. Inside a
    :meth:`Piecewise.capture` on this thread the call ends the graph being
    captured, runs eagerly and becomes a step of the recording."""
    rec = getattr(_recording, "piecewise", None)
    if rec is None:
        return getattr(module, name)(*args, **kwargs)
    return rec._call(module, name, args, kwargs)


def leaves(tree) -> list:
    """The tensors of nested tuples (named or plain) and lists, depth
    first; None leaves skipped."""
    out = []

    def visit(node):
        if isinstance(node, torch.Tensor):
            out.append(node)
        elif isinstance(node, (tuple, list)):
            for item in node:
                visit(item)
    visit(tree)
    return out


def _spec(node, slot):
    """``node``'s structure with each tensor replaced by ``slot(tensor)``;
    no tensor is kept."""
    if isinstance(node, torch.Tensor):
        return slot(node)
    if isinstance(node, (tuple, list)):
        return type(node), [_spec(n, slot) for n in node]
    return None


def _rebuild(spec, tensors):
    """The tree ``spec`` describes (:func:`_spec`), its slots filled from
    ``tensors``."""
    if spec is None or isinstance(spec, int):
        return None if spec is None else tensors[spec]
    kind, items = spec
    items = [_rebuild(s, tensors) for s in items]
    return kind(*items) if hasattr(kind, "_fields") else kind(items)


def _by_dtype(tensors) -> list:
    """The indices of ``tensors``, grouped by dtype."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.values())


def _unique(tree) -> list:
    """The tensors of ``tree`` in first-seen order, an aliased one once."""
    seen = {}
    for t in leaves(tree):
        seen.setdefault(id(t), t)
    return list(seen.values())


class _Call:
    """A kernel call of a recording: made again, its outputs copied into
    the tensors the capture handed on."""

    __slots__ = ("module", "name", "args", "kwargs", "outs")

    def __init__(self, module, name, args, kwargs, outs):
        self.module, self.name = module, name
        self.args, self.kwargs, self.outs = args, kwargs, outs

    def __call__(self):
        out = getattr(self.module, self.name)(*self.args, **self.kwargs)
        if isinstance(out, torch.Tensor):
            self.outs[0].copy_(out)
        else:
            torch._foreach_copy_(self.outs, list(out))


class Piecewise:
    """A recording: ``stages`` is [(name, [step])], each step a callable
    (a graph's replay or a :class:`_Call`), in the order of the run. Every
    graph of one recording shares one memory pool, captured in the order it
    replays."""

    def __init__(self, device):
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.stages = []
        self._graph = None

    @contextlib.contextmanager
    def capture(self):
        """Records the body's stages (:meth:`stage`) on :attr:`stream`."""
        with torch.cuda.stream(self.stream):
            _recording.piecewise = self
            try:
                yield self
                self._end()
            finally:
                _recording.piecewise = None
                if self._graph is not None:      # the body raised
                    self._graph, g = None, self._graph
                    with contextlib.suppress(RuntimeError):
                        g.capture_end()

    @contextlib.contextmanager
    def stage(self, name: str):
        """Starts stage ``name`` with a graph of its own; the graph stays
        open past the block, up to the next stage, kernel call or the
        capture's end."""
        self._end()
        self.stages.append((name, []))
        self._begin()
        yield

    def _begin(self):
        self._graph = torch.cuda.CUDAGraph()
        self._graph.capture_begin(pool=self.pool,
                                  capture_error_mode="thread_local")

    def _end(self):
        if self._graph is not None:
            g, self._graph = self._graph, None
            g.capture_end()
            self.stages[-1][1].append(g.replay)

    def _call(self, module, name, args, kwargs):
        self._end()
        out = getattr(module, name)(*args, **kwargs)
        outs = [out] if isinstance(out, torch.Tensor) else list(out)
        self.stages[-1][1].append(_Call(module, name, args, kwargs, outs))
        self._begin()
        return out


def _copy(dsts, srcs):
    """``d.copy_(s)`` pair by pair: the contiguous sources with one
    ``torch._foreach_copy_`` a dtype (a strided one would send the whole
    list down the foreach copy's launch-a-tensor path), the rest alone."""
    dense = [i for i, t in enumerate(srcs) if t.is_contiguous()]
    for idx in _by_dtype([srcs[i] for i in dense]):
        torch._foreach_copy_([dsts[dense[i]] for i in idx],
                             [srcs[dense[i]] for i in idx])
    for d, t in zip(dsts, srcs):
        if not t.is_contiguous():
            d.copy_(t)


class StaticInputs:
    """Contiguous buffers shaped as the tensors of ``tree``, one a position
    (:attr:`tree`, the same structure), filled by :meth:`copy_from` from a
    tree of that layout with one ``torch._foreach_copy_`` a dtype; a
    position that holds its own buffer is left as it is (a capture that
    writes its result back over its inputs keeps some of them)."""

    def __init__(self, tree):
        self._buffers = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                         for t in leaves(tree)]
        slots = iter(range(len(self._buffers)))
        self.tree = _rebuild(_spec(tree, lambda t: next(slots)),
                             self._buffers)

    def copy_from(self, tree):
        pairs = [(b, t) for b, t in zip(self._buffers, leaves(tree))
                 if t is not b]
        _copy([b for b, _ in pairs], [t for _, t in pairs])


class FlatOutputs:
    """The tensors of ``tree`` laid out in one flat buffer a dtype:
    :meth:`write` copies them in (inside a capture, as part of its graph),
    :meth:`take` clones the buffers, one copy a dtype, and returns
    ``tree``'s structure over views of the clones, which belong to the
    caller. (Views of one dtype a storage: ``torch.save`` takes them.)"""

    def __init__(self, tree):
        slot_of = {}
        self._spec = _spec(
            tree, lambda t: slot_of.setdefault(id(t), len(slot_of)))
        srcs = _unique(tree)
        self._layout = [None] * len(srcs)
        self.buffers = []
        for idx in _by_dtype(srcs):
            line, off = max(ALIGN // srcs[idx[0]].element_size(), 1), 0
            for i in idx:
                t = srcs[i]
                self._layout[i] = (len(self.buffers), off, t.shape,
                                   _contiguous_strides(t.shape))
                off += -(-t.numel() // line) * line
            self.buffers.append(torch.empty(off, dtype=srcs[idx[0]].dtype,
                                            device=srcs[idx[0]].device))
        self._views = self._over(self.buffers)

    def _over(self, buffers) -> list:
        return [buffers[b].as_strided(shape, strides, start)
                for b, start, shape, strides in self._layout]

    def write(self, tree):
        _copy(self._views, _unique(tree))

    def take(self):
        return _rebuild(self._spec,
                        self._over([b.clone() for b in self.buffers]))


def _contiguous_strides(shape) -> tuple:
    strides, acc = [], 1
    for n in reversed(shape):
        strides.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(strides))
