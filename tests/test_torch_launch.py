"""The launch seam (`huffman_tpu_torch/ops/launch.py`) on the CPU, with a
stub library in place of a built one (no nvcc): what is checked before a C
entry is called, the stream appended last, the return code and the launch
count.  ctypes itself wraps an integer that does not fit its C type
without a word, so the seam's range check is all that stands between a
corrupt value and the kernel.
"""

import ctypes
import re
import types

import pytest
import torch

from huffman_tpu_torch.ops import cuda_build
from huffman_tpu_torch.ops import launch as seam
from huffman_tpu_torch.utils import trace

STREAM = 0x5EED
# the stub entry's parameters, as its source would declare them:
# (const void* p, int i, long long n, void* stream)
SIGNATURE = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_void_p]
I32, I64 = 1 << 31, 1 << 63


class StubLib:
    """A library of one entry that records its calls and returns ``rc``."""

    def __init__(self):
        self.rc, self.calls = 0, []

    def stub_launch(self, *args):
        self.calls.append(args)
        return self.rc


LIB = StubLib()


def stub_wrapper():
    """The wrapper the stub's launches are counted for."""


@pytest.fixture
def stub(monkeypatch):
    LIB.rc, LIB.calls = 0, []
    monkeypatch.setattr(cuda_build, "signatures",
                        lambda: {"stub": {"stub_launch": SIGNATURE}})
    monkeypatch.setattr(cuda_build, "load_kernels", lambda: {"stub": LIB})
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device:
                        types.SimpleNamespace(cuda_stream=STREAM))
    trace.reset_launches(("stub_wrapper",))
    yield LIB
    trace.reset_launches(("stub_wrapper",))


def _launch(*args):
    seam.launch("stub", "stub_launch", *args, like=torch.empty(1),
                counted=stub_wrapper)


# (arguments, return code, error, its message, calls made, launches counted)
CASES = {
    "int 2^31": ((None, I32, 0), 0, ValueError,
                 "argument 1 of stub_launch is 2147483648", 0, 0),
    "int -2^31-1": ((None, -I32 - 1, 0), 0, ValueError,
                    "argument 1 of stub_launch is -2147483649", 0, 0),
    "long long 2^63": ((None, 0, I64), 0, ValueError,
                       "argument 2 of stub_launch is 9223372036854775808",
                       0, 0),
    "long long -2^63-1": ((None, 0, -I64 - 1), 0, ValueError,
                          "argument 2 of stub_launch is "
                          "-9223372036854775809", 0, 0),
    "too few arguments": ((None, 0), 0, ValueError,
                          "stub_launch takes 3 arguments before the "
                          "stream, got 2", 0, 0),
    "too many arguments": ((None, 0, 0, 0), 0, ValueError,
                           "stub_launch takes 3 arguments before the "
                           "stream, got 4", 0, 0),
    "non-zero return code": ((0x1000, 7, 9), 700, RuntimeError,
                             "CUDA launch failed (cudaError 700)", 1, 0),
    "good call at the limits": ((0x1000, I32 - 1, -I64), 0, None, None, 1, 1),
    "good call, null pointer": ((None, -I32, I64 - 1), 0, None, None, 1, 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_launch_checks_calls_and_counts(stub, case):
    args, rc, error, message, n_calls, n_counted = CASES[case]
    stub.rc = rc
    if error is None:
        _launch(*args)
    else:
        with pytest.raises(error, match=re.escape(f"stub_wrapper: {message}")):
            _launch(*args)
    assert len(stub.calls) == n_calls
    if n_calls:
        # the arguments as given, the stream of `like`'s device last
        assert stub.calls[0] == (*args, STREAM)
    assert trace.launches(("stub_wrapper",)) == {"stub_wrapper": n_counted}


def test_counters_read_and_reset_their_own_wrappers():
    def one():
        """a wrapper"""

    def two():
        """another"""

    reset, counts = seam.counters(one, two)
    reset()
    trace.count(trace.LAUNCH + "one", 3)
    trace.count(trace.LAUNCH + "other", 1)
    assert counts() == {"one": 3, "two": 0}
    reset()
    assert counts() == {"one": 0, "two": 0}
    assert trace.launches(("other",)) == {"other": 1}
    trace.reset_launches(("other",))
