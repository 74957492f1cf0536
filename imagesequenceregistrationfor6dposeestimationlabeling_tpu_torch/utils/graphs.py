"""CUDA graphs of a function at fixed shapes.

A ``Graph`` captures ``fn(*args)`` once and replays it for later
arguments of the same shapes and dtypes: the same kernels in the same
order, launched by one call instead of one host launch each.  The
arguments are copied into the graph's own input buffers (with the first
arguments' strides, an expanded one's dense), and the outputs
come back as clones, so a result outlives the next call.  A
``torch.Generator`` argument has a generator of the graph's own in its
place: each call starts it from the argument's state and hands its state
back after, so ``fn``'s draws (in a cut, see below) take the argument's
numbers and advance it as an eager call would, and the warm-up before a
capture leaves the argument where it was.

An op that syncs the card with the host (a result or an error flag read
back) cannot be captured.  ``fn`` runs such an op through ``cut(op,
*args)``: outside a capture that is ``op(*args)``; inside one it ends
the graph being captured, runs the op eagerly and begins the next graph,
and every replay then runs the graphs in turn with the op eagerly between
them.  The graphs of one ``Graph`` share a memory pool and replay in the
order they were captured.

Nothing here runs while the module is imported.
"""

from __future__ import annotations

import torch

# the Graph being captured, while one is
_capturing = None


def cut(op, *args):
    """``op(*args)``; during a capture, run eagerly between two graphs."""
    if _capturing is None:
        return op(*args)
    return _capturing._cut(op, args)


def _tensors(out) -> tuple:
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


def _buffer(a):
    if a is None:
        return None
    if isinstance(a, torch.Generator):
        return torch.Generator(device=a.device)
    if 0 in a.stride():
        # an expanded argument: a dense buffer of its shape
        return torch.empty_like(a, memory_format=torch.contiguous_format)
    # the argument's own strides: a kernel that picks its variant by the
    # layout (torch.gather's vectorized one on dense rows) is the one an
    # eager call on the argument launches
    return torch.empty_strided(a.shape, a.stride(), dtype=a.dtype, device=a.device)


class Graph:
    """``fn`` (tensors, generators or None -> a tuple of tensors) captured
    on ``device`` at the shapes of its first arguments."""

    def __init__(self, fn, args, device):
        self.fn, self.device = fn, torch.device(device)
        self.inputs = [_buffer(a) for a in args]
        # in replay order: a CUDAGraph, or a cut (op, its args, its outputs)
        self.steps = []
        self.pool = None
        self.outputs = ()

    def _load(self, args):
        for buf, a in zip(self.inputs, args):
            if isinstance(buf, torch.Generator):
                buf.set_state(a.get_state())
            elif buf is not None:
                buf.copy_(a)

    def _generators(self, args) -> list:
        """(the graph's generator, the argument's) pairs."""
        return [(buf, a) for buf, a in zip(self.inputs, args) if isinstance(buf, torch.Generator)]

    def _store(self, args):
        for buf, a in self._generators(args):
            a.set_state(buf.get_state())

    def _begin(self):
        g = torch.cuda.CUDAGraph()
        g.capture_begin(pool=self.pool)
        self.steps.append(g)

    def _end(self):
        # replayed at once, so that a cut op after it reads real values
        self.steps[-1].capture_end()
        self.steps[-1].replay()

    def _cut(self, op, args):
        self._end()
        out = op(*args)
        self.steps.append((op, args, _tensors(out)))
        self._begin()
        return out

    def capture(self, args) -> tuple:
        """Warm ``fn`` up on a side stream (lazy handles and workspaces),
        capture it there and return its outputs for ``args``."""
        global _capturing
        with torch.cuda.device(self.device):
            self._load(args)
            main, side = torch.cuda.current_stream(), torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self.fn(*self.inputs)
                for buf, a in self._generators(args):
                    buf.set_state(a.get_state())    # the warm-up's draws are taken back
                self.pool = torch.cuda.graph_pool_handle()
                _capturing = self
                try:
                    self._begin()
                    self.outputs = self.fn(*self.inputs)
                    self._end()
                except BaseException:
                    if torch.cuda.is_current_stream_capturing():
                        self.steps[-1].capture_end()    # leave the stream usable
                    raise
                finally:
                    _capturing = None
            main.wait_stream(side)
            self._store(args)
            return tuple(o.clone() for o in self.outputs)

    def __call__(self, args) -> tuple:
        """``fn(*args)`` by replay, as clones of the graph's outputs."""
        with torch.cuda.device(self.device):
            self._load(args)
            for step in self.steps:
                if isinstance(step, tuple):
                    op, op_args, outs = step
                    for o, new in zip(outs, _tensors(op(*op_args))):
                        o.copy_(new)
                else:
                    step.replay()
            self._store(args)
            return tuple(o.clone() for o in self.outputs)
