"""Every kernel wrapper of the port launches under its tensor's card.

The C entry points copy their constants and launch on the current CUDA
device; ``ops/pairing._launch_on`` makes the tensor's card the current
device around each launch and takes that card's stream. Checked on the
CPU with stand-ins for ``torch.cuda.device`` and
``torch.cuda.current_stream``, and by reading the wrappers' sources."""

import ast
import ctypes
import inspect
import textwrap

import pytest
import torch

from drand_tpu_torch.ops import eval as ev, msm, pairing, wire


class _Card:
    def __init__(self, index: int):
        self.device = torch.device("cuda", index)


def test_launch_on_enters_the_tensors_device_and_takes_its_stream(
        monkeypatch):
    entered, streams = [], []

    class FakeDevice:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            entered.append(("enter", self.device))

        def __exit__(self, *exc):
            entered.append(("exit", self.device))
            return False

    class FakeStream:
        cuda_stream = 0x5EED

    def fake_current_stream(device=None):
        streams.append((device, entered[-1]))
        return FakeStream()

    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    monkeypatch.setattr(torch.cuda, "current_stream", fake_current_stream)
    card = _Card(1)
    with pairing._launch_on(card) as stream:
        assert entered == [("enter", card.device)]
        assert isinstance(stream, ctypes.c_void_p)
        assert stream.value == 0x5EED
    assert entered == [("enter", card.device), ("exit", card.device)]
    # the stream is the tensor's card's, asked for inside the guard
    assert streams == [(card.device, ("enter", card.device))]


def _launch_calls(fn):
    """The C entry points ``fn`` calls, each with whether it is called
    inside a ``with _launch_on(...)`` block."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    found = []

    def visit(node, guarded):
        if isinstance(node, ast.With):
            guarded = guarded or any(
                isinstance(it.context_expr, ast.Call)
                and getattr(it.context_expr.func, "id", "") == "_launch_on"
                for it in node.items)
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr.endswith("_launch")):
            found.append((node.func.attr, guarded))
        for child in ast.iter_child_nodes(node):
            visit(child, guarded)

    visit(tree, False)
    return found


@pytest.mark.parametrize("fn, entry", [
    (pairing.miller_loop, "miller_loop_launch"),
    (pairing.final_exp_verdict, "final_exp_verdict_launch"),
    (msm.msm, "msm_launch"),
    (ev.horner, "eval_horner_launch"),
    (wire.hash_to_g2, "hash_to_g2_launch"),
    (wire.decompress_g2, "decompress_g2_launch"),
])
def test_every_wrapper_launches_under_launch_on(fn, entry):
    assert _launch_calls(fn) == [(entry, True)]
    assert "current_stream" not in inspect.getsource(fn)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the second card, so that a
    wrapper takes its launch path here."""

    @property
    def device(self):
        return torch.device("cuda", 1)


def test_stacked_msm_launches_once_under_its_tensors_card(monkeypatch):
    """msm on stacked points (k, b, 2, 2, 12) makes ONE launch of the k
    sums, inside the tensor's card's guard and on its stream, with scratch
    and output sized for k sums; it counts one launch."""
    entered, calls = [], []

    class FakeDevice:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            entered.append(self.device)

        def __exit__(self, *exc):
            entered.append(None)
            return False

    class FakeStream:
        cuda_stream = 0x5EED

    class FakeLib:
        def msm_scratch_words(self, n, k):
            return 7 * n * k

        def msm_launch(self, *args):
            calls.append((list(entered), args))
            return 0

    empty = torch.empty
    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: FakeStream())
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **kw:
                        empty(*a, **kw))
    monkeypatch.setattr(msm, "_lib", FakeLib)
    monkeypatch.setattr(msm, "_consts_on",
                        lambda device: torch.zeros(3, dtype=torch.int32))
    k, b, nbits = 2, 5, 16
    pts, mask, bits = (torch.zeros(shape, dtype=torch.int32).as_subclass(
        _OnCard) for shape in ((k, b, 2, 2, 12), (b,), (b, nbits)))
    before = msm.LAUNCHES["msm"]
    xy, inf = msm.msm(pts, mask, bits)
    assert msm.LAUNCHES["msm"] == before + 1
    assert xy.shape == (k, 2, 2, 12) and inf.shape == (k, 1)
    (inside, args), = calls
    assert inside == [torch.device("cuda", 1)]
    # consts, n_words, pts, mask, bits, nbits, scratch, scratch_words,
    # out, n, k, stream
    assert (args[5], args[7], args[9], args[10]) == (nbits, 7 * b * k, b, k)
    assert args[11].value == 0x5EED
