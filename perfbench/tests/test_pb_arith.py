"""The traced run's arithmetic: the union of device intervals, the idle
gaps, and the least bytes of each wrapped kernel's launch."""

import pytest
import torch

from perfbench import devtrace as tr


@pytest.mark.parametrize("intervals, busy", [
    ([], 0.0),
    ([(0, 2), (1, 3)], 3.0),  # overlap
    ([(0, 1), (2, 3)], 2.0),  # apart
    ([(0, 4), (1, 2)], 4.0),  # nested
    ([(5, 6), (0, 1), (0.5, 2)], 3.0),  # out of order
])
def test_merged(intervals, busy):
    assert tr.merged(intervals) == busy


def test_gaps():
    assert tr.gaps([(1, 2), (1.5, 3), (5, 6)], 0, 8) == [(0, 1), (3, 5),
                                                          (6, 8)]
    assert tr.gaps([(0, 10)], 2, 8) == []
    assert tr.gaps([], 2, 8) == [(2, 8)]


def test_run_scan_bytes():
    keys = torch.zeros(1000, dtype=torch.int64)
    assert tr.run_scan_bytes((keys,), {}, None) == 12 * 1000


def test_stitch_bytes():
    """Each row's kept prefix read (the last row whole), the offsets
    read, the whole output written."""
    rows = torch.zeros((3, 8), dtype=torch.int64)
    lens = [4, 0, 8]
    offs = torch.tensor([0, 4, 4], dtype=torch.int32)
    kept = sum(lens)
    assert tr.stitch_bytes((rows, offs, 0), {}, None) == (
        8 * kept + 4 * 3 + 8 * 3 * 8)


def test_hash_insert_bytes():
    slots = torch.zeros((64, 2), dtype=torch.int64)
    claims = torch.zeros(1, dtype=torch.int64)
    keys = torch.zeros(100, dtype=torch.int64)
    amounts = torch.zeros(100, dtype=torch.int32)
    assert tr.hash_insert_bytes((slots, claims, keys), {}, 7) == (
        8 * 100 + 64 * 7)
    assert tr.hash_insert_bytes((slots, claims, keys, amounts), {}, 7) == (
        12 * 100 + 64 * 7)
    source = torch.zeros((32, 2), dtype=torch.int64)
    assert tr.hash_insert_bytes((slots, claims, source), {}, 5) == (
        16 * 32 + 64 * 5)


def test_changed_sectors():
    """16 B slots, two a 32 B sector: slots 0 and 1 share one."""
    before = torch.zeros((8, 2), dtype=torch.int64)
    after = before.clone()
    after[0, 0] = 1
    after[1, 1] = 1
    after[6, 0] = 1
    assert tr.changed_sectors(before, after) == 2
    assert tr.changed_sectors(before, before.clone()) == 0


class Event:
    """A profiler event as the raw event list gives it."""

    def __init__(self, name, device, start, end, corr):
        from torch.autograd import DeviceType

        self._name, self._start, self._end, self._corr = (name, start, end,
                                                          corr)
        self._device = DeviceType.CUDA if device else DeviceType.CPU

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._name.startswith(tr.SPAN_PREFIX)


def test_kernel_device_time_by_launch_inside_the_range():
    span = Event(tr.KERNEL_PREFIX + "run_starts", False, 100, 200, 7)
    events = [span,
              Event("cudaLaunchKernel", False, 150, 160, 31),
              Event("cudaLaunchKernel", False, 250, 260, 32),  # after it
              Event("run_starts_kernel", True, 300, 1300, 31),
              Event("other_kernel", True, 1300, 1500, 32),
              Event(tr.KERNEL_PREFIX + "run_starts", True, 300, 1400, 7)]
    assert tr.kernel_device_s(events, [span]) == {"run_starts": [1e-6]}


def test_least_time():
    assert tr.least_s(3_350_000_000) == pytest.approx(1e-3)


def test_wraps_pass_cpu_calls_through(monkeypatch):
    """On the CPU a wrapped entry point runs unchanged and notes nothing;
    remove() puts the original back."""
    from sharkmer_tpu_torch.ops import sorted_store

    original = sorted_store.run_starts
    wraps = tr.KernelWraps()
    wraps.install()
    try:
        assert sorted_store.run_starts is not original
        keys = torch.tensor([1, 1, 2, 5, 5, 5])
        assert sorted_store.run_starts(keys).tolist() == [0, 0, 2, 3, 3, 3]
        assert wraps.launches == []
    finally:
        wraps.remove()
    assert sorted_store.run_starts is original
