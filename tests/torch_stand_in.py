"""A CUDA graph's stand-in on the CPU, for the tests of the captured
solves (``pyamg_tpu_torch/_graph.py``).  Imports only torch and the port,
so that the gloo worker processes (``torch_dist_worker.py``) use it too.

A CUDA graph exists only on the card.  The stand-in's capture runs the
step once as the card records it, with every host read of a tensor and
every host-to-device copy made to raise (a tensor made from host data, a
Python number written into a tensor), then puts the state back as it
found it; its replay runs the step again.  Its device loop runs the tree
as the card does, reading the flags and counters itself.
"""

import contextlib

import pytest
import torch

from pyamg_tpu_torch import _graph

READS = ("__bool__", "__float__", "__int__", "__index__", "item", "tolist",
         "numpy")


def _refuse(*args, **kwargs):
    raise AssertionError("host access inside a captured step")


@contextlib.contextmanager
def on_card_rules():
    """What a capture on the card refuses, made to raise on the CPU: a
    host read of a tensor, a tensor made from host data, a Python number
    written into a tensor."""
    real_as_tensor = torch.as_tensor
    real_setitem = torch.Tensor.__setitem__

    def as_tensor(data, *args, **kwargs):
        if not isinstance(data, torch.Tensor):
            _refuse()
        return real_as_tensor(data, *args, **kwargs)

    def setitem(self, index, value):
        if isinstance(value, (bool, int, float, complex)):
            _refuse()
        return real_setitem(self, index, value)

    with pytest.MonkeyPatch.context() as mp:
        for name in READS:
            mp.setattr(torch.Tensor, name, _refuse)
        mp.setattr(torch, "tensor", _refuse)
        mp.setattr(torch, "from_numpy", _refuse)
        mp.setattr(torch, "as_tensor", as_tensor)
        mp.setattr(torch.Tensor, "__setitem__", setitem)
        yield


def _tensors(prog):
    out = list(prog.state.values())
    for obj in prog.objects.values():
        out += [t for t in getattr(obj, "__dict__", {}).values()
                if isinstance(t, torch.Tensor)]
    return out


class StandIn:
    """A CUDA graph's stand-in: ``capture(body)`` runs the step under
    ``on_card_rules`` from the state the warm-up started from, where the
    program recorded one (recording its launch bookkeeping), then puts
    the program's tensors back as it found them; ``replay()`` runs it
    again, its own tallies discarded (the program adds those the capture
    recorded)."""

    def __init__(self, prog):
        self.prog = prog
        self.body = None

    def capture(self, body):
        tensors = _tensors(self.prog)
        after = [t.clone() for t in tensors]
        for t in tensors:
            if id(t) in self.prog.before:
                t.copy_(self.prog.before[id(t)])
        self.prog.before = {}
        with on_card_rules():
            body()
        for t, a in zip(tensors, after):
            t.copy_(a)
        self.body = body

    def replay(self):
        saved = _graph._recording
        _graph._recording = []
        try:
            with on_card_rules():
                self.body()
        finally:
            _graph._recording = saved


_REAL = {name: getattr(torch.Tensor, name) for name in READS}


class StandInLoop:
    """A device loop's stand-in (``_graph._DeviceLoop``): ``launch()``
    runs the tree as the card does, each step by its stand-in graph's
    replay (under ``on_card_rules``), each While while its flag is clear
    and its counter below the limit, each Every by its counter, each
    Switch by its index, tallying the trips of each body.  Reading the flags and counters here is the
    stand-in modelling the device: it goes past the patches that count
    and refuse host reads."""

    def __init__(self, nodes, tally, slots):
        self.nodes, self.tally, self.slots = nodes, tally, slots

    def launch(self):
        self.tally.zero_()
        self._run(self.nodes)

    def _run(self, nodes):
        for n in nodes:
            if isinstance(n, _graph.Step):
                n.prog.graphs[n.name][0].replay()
                continue
            st, slot = n.prog.state, self.slots[id(n)]
            if isinstance(n, _graph.Switch):
                k = _REAL["__int__"](st[n.index])
                if 0 <= k < len(n.branches):
                    self.tally[slot + k] += 1
                    self._run(n.branches[k])
                continue
            if isinstance(n, _graph.Every):
                then = (_REAL["__int__"](st[n.count]) + 1) % n.every == 0
                self.tally[slot + (0 if then else 1)] += 1
                self._run(n.then if then else n.other)
                continue
            while not _REAL["__bool__"](st[n.stop]) and \
                    _REAL["__int__"](st[n.count]) < n.limit:
                self._run(n.body)
                self.tally[slot] += 1


class StandInGraphs(_graph.Graphs):
    """A captured program on the CPU, graphs by ``StandIn`` and loops by
    ``StandInLoop``; it keeps the state as it was before each warm-up of a
    step run by itself, which the stand-in records from (on the card a
    capture runs nothing)."""

    def __init__(self, owned=None):
        super().__init__(torch.device("cpu"), None, None,
                         graph_type=lambda pool: StandIn(self), owned=owned,
                         loop_type=StandInLoop)
        self.before = {}
        self.before_warm = {}

    def _warm(self, name, step):
        self.before_warm[name] = {id(t): t.clone() for t in _tensors(self)}
        super()._warm(name, step)

    def _capture(self, name, step):
        self.before = self.before_warm.pop(name, {})
        super()._capture(name, step)


def _stand_in_program(owned=None):
    return StandInGraphs(owned)


@contextlib.contextmanager
def stand_in_programs():
    """Every hierarchy's (and distributed hierarchy's) programs captured
    with the stand-in, as a CUDA device would capture them."""
    def transient(self, device, captured=True):
        if not captured or _graph._eager:
            return _graph.Program()
        return _stand_in_program(self.owned)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_graph.Cache, "transient", transient)
        yield
