"""The ``fused_tail_share`` reader on the CPU: the program's pooled-segment
counter in percent; None on a program without the counter (a
``wavefront_fused`` with no ``tail_share``) and before any launch of the
tail instance."""

import importlib

import pytest

from tpurt_torch.kernels import wavefront_fused


def read(rec):
    return importlib.import_module(
        "bench_torch.metrics.fused_tail_share").read(rec)


def test_none_without_the_counter(monkeypatch):
    monkeypatch.delattr(wavefront_fused, "tail_share")
    assert read({}) is None


def test_none_before_a_launch_of_the_instance(monkeypatch):
    monkeypatch.setattr(wavefront_fused, "_TAIL", {})
    assert read({}) is None


def test_reads_percent(monkeypatch):
    monkeypatch.setattr(wavefront_fused, "tail_share", lambda: 0.045)
    assert read({}) == pytest.approx(4.5)
