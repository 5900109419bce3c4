"""The comparison that decides ``correct`` has to fail a broken program.

Each case drives a whole run on the CPU at a small size (set-up, window,
check: all but the harness's look for a card) with the timed path broken
underneath, and sees ``correct`` come out false (among the faults an
answer remembered from the call before, which the bulk loop's turns of
distinct inputs and the pages' walk expose); the sound run and the
control (`benchmark/control.py`) frame them.  Every cell of one card of
BENCHMARK.json takes each fault its loop can have: a fault of the answer
where the loop's driver decodes or reads, and of the encode where it
encodes.
"""

import pytest
import torch

from benchmark import control, spec as specs
from benchmark.tests.test_bench_harness import ONE_CARD, tiny_run


def _flip_first(out):
    out.view(-1)[0] ^= 1
    return out


def _drop_half(out):
    flat = out.view(-1)
    flat[flat.numel() // 2:] = 0
    return out


def _undone(out):
    return torch.zeros_like(out)


def _decode_fault(driver, fault):
    return lambda codec, comp: fault(driver.decode(codec, comp))


def _read_fault(driver, fault):
    return lambda blob, device, span: fault(driver.read(blob, device, span))


def _remembered(fn):
    """The answer of the call before, as a cache that ignores its key
    would give it."""
    outs = []

    def call(*args):
        outs.append(fn(*args))
        return outs.pop(0) if len(outs) > 1 else outs[0]
    return call


def _largest_tensor(obj):
    """The largest tensor held in an encode's output (its payload)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        items = obj
    elif hasattr(obj, "__dict__"):
        items = vars(obj).values()
    else:
        return []
    found = [t for x in items for t in _largest_tensor(x)]
    return [max(found, key=torch.Tensor.numel)] if found else []


def _encode_fault(driver):
    """One payload word altered where the encode writes it."""
    def encode(codec, data):
        comp = driver.encode(codec, data)
        [words] = _largest_tensor(comp)
        words.view(-1)[words.numel() // 3] ^= 1 << 7
        return comp
    return encode


FAULTS = {
    "answer_altered": _flip_first,
    "half_left_out": _drop_half,
    "returns_undone": _undone,
}


def _needs(workload):
    spec = specs.load_spec()
    return specs.loop(specs.mix(specs.cell(spec, workload)["traffic"])["loop"]).DRIVER_NEEDS


def _patch(workload, kind):
    spec = specs.load_spec()
    driver = specs.driver(specs.config(spec, specs.cell(spec, workload)["config"])["driver"])
    if kind == "encode_altered":
        return {"encode": _encode_fault(driver)}
    if kind == "encode_remembered":
        return {"encode": _remembered(driver.encode)}
    fn = "read" if "read" in _needs(workload) else "decode"
    if kind == "answer_remembered":
        return {fn: _remembered(getattr(driver, fn))}
    if fn == "read":
        return {"read": _read_fault(driver, FAULTS[kind])}
    return {"decode": _decode_fault(driver, FAULTS[kind])}


@pytest.mark.parametrize("workload", ONE_CARD)
def test_sound_run_is_correct(workload):
    assert tiny_run(workload, seed=11)["correct"]


CASES = [(w, k) for w in ONE_CARD for k in [*FAULTS, "answer_remembered"]] + [
    (w, k) for w in ONE_CARD if "encode" in _needs(w)
    for k in ("encode_altered", "encode_remembered")]


@pytest.mark.parametrize("workload,kind", CASES)
def test_planted_fault_is_not_correct(workload, kind):
    out = tiny_run(workload, seed=11, patch=_patch(workload, kind))
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("workload", ONE_CARD)
def test_control_is_not_correct(workload):
    for seed in (21, 22, 23):
        out = control.run_seed(workload, seed, 0.2, "cpu",
                               overrides=specs.tiny(workload))
        assert out["correct"] is False
        assert out["checks"]["table_len_diff"]["value"] > 0
        assert all(c["value"] == 0 for k, c in out["checks"].items()
                   if k != "table_len_diff")
