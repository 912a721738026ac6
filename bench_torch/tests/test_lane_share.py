"""The ``path_lane_share`` reader on the CPU: the program's lane counter in
percent; None on a program without the counter (a ``mega_regen`` with no
``lane_share``) and before any pool launch."""

import importlib

import pytest

from tpurt_torch.kernels import mega_regen


def read(rec):
    return importlib.import_module(
        "bench_torch.metrics.path_lane_share").read(rec)


def test_none_without_the_counter(monkeypatch):
    monkeypatch.delattr(mega_regen, "lane_share")
    assert read({}) is None


def test_none_before_a_pool_launch(monkeypatch):
    monkeypatch.setattr(mega_regen, "POOL_LAUNCHES", 0)
    assert read({}) is None


def test_reads_percent(monkeypatch):
    monkeypatch.setattr(mega_regen, "lane_share", lambda: 0.75)
    assert read({}) == pytest.approx(75.0)
