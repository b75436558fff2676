"""``flash_bwd_roofline`` on synthetic traced slices: the least time of each
recorded launch's backward over the device time of the flash_bwd kernels,
read only when they number two a launch."""

import importlib.util
import types
from pathlib import Path

import pytest

from portbench.trace import Slice

PB = Path(__file__).parents[1]
SHAPE = (128, 8, 631, 64)


def reader():
    spec = importlib.util.spec_from_file_location("m_flash_bwd_roofline",
                                                  PB / "metrics" / "flash_bwd_roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traced(kernels, launches):
    """A run whose slice holds device kernels ``kernels`` ((name, ns), back to
    back) and the recorded forward launches ``launches``."""
    sl = Slice(sync=False)
    t, sl.device = 0, []
    for name, ns in kernels:
        sl.device.append((name, t, t + ns))
        t += ns
    sl.launches = list(launches)
    return types.SimpleNamespace(slice=sl, counters={})


def test_the_bound_is_the_operations_at_the_training_shape():
    mod = reader()
    # 10 * B * H * N^2 * dh at 989 TFLOP/s: 0.2638 ms, above the bytes' 0.1983 ms.
    assert mod.backward_bound_ms(SHAPE, 631) == pytest.approx(
        10 * 128 * 8 * 631 * 631 * 64 / 989e12 * 1e3)
    # At N = 379 the bytes take longer than the operations.
    bytes_ms = ((4 * 379 + 4 * 379) * 64 * 2 + 4 * 379) * 128 * 8 / 3.35e12 * 1e3
    assert mod.backward_bound_ms((128, 8, 379, 64), 379) == pytest.approx(bytes_ms)


def test_two_kernels_a_launch_give_the_share():
    mod = reader()
    launches = [(SHAPE, 631, True, None)] * 4
    kernels = [("void flash_fwd_bf16<64, true, true>(...)", 364_000)] * 4
    kernels += [("void flash_bwd_dq_bf16<true>(...)", 400_000),
                ("void flash_bwd_dkdv_bf16<true>(...)", 600_000)] * 4
    got = mod.read(traced(kernels, launches))
    assert got == pytest.approx(100 * mod.backward_bound_ms(SHAPE, 631) / 1.0)


@pytest.mark.parametrize("case", ["no backward kernel", "one kernel short", "float32",
                                  "dh 128", "nothing traced"])
def test_nothing_to_read_gives_none(case):
    mod = reader()
    launches = [(SHAPE, 631, True, None)] * 2
    bwd = [("void flash_bwd_dq_bf16<true>(...)", 1), ("void flash_bwd_dkdv_bf16<true>(...)", 1)]
    kernels = [("void flash_fwd_bf16<64, true, false>(...)", 1)] * 2 + bwd * 2
    if case == "no backward kernel":  # a parent whose backward is the math path
        kernels = kernels[:2]
    elif case == "one kernel short":
        kernels = kernels[:-1]
    elif case == "float32":
        launches = [(SHAPE, 631, False, None)] * 2
    elif case == "dh 128":
        launches = [((128, 8, 631, 128), 631, True, None)] * 2
    else:
        launches = []
    assert mod.read(traced(kernels, launches)) is None
