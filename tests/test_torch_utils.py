"""The port's ``utils/logger.py`` and ``utils/profiling.py`` on the CPU.

``ScalarWriter``'s records equal the JAX package's (the wall clock
aside), ``AverageMeter`` and ``get_logger`` behave as JAX's, ``trace``
writes a Chrome trace with the port's spans as ranges (the rest of the
tracing: ``tests/test_torch_tracing.py``), and
``device_memory_stats`` has the JAX names (empty without a card; the
card's test is in ``tests/test_torch_card_tools.py``).
"""

import json
import logging

import torch

from gapro_tpu.utils import logger as jlogger
from gapro_tpu_torch.utils import logger, profiling


def _records(path):
    return [json.loads(line) for line in open(path)]


def test_scalar_writer_matches_jax(tmp_path):
    for mod, d in ((logger, tmp_path / "torch"), (jlogger, tmp_path / "jax")):
        w = mod.ScalarWriter(str(d))
        w.add_scalar("loss", torch.tensor(1.5) if mod is logger else 1.5, 3)
        w.add_scalar("lr", 1e-3, 4)
        w.close()
    got, want = _records(tmp_path / "torch" / "scalars.jsonl"), _records(
        tmp_path / "jax" / "scalars.jsonl")
    assert [list(r) for r in got] == [list(r) for r in want] == [["step", "tag", "value",
                                                                   "wall"]] * 2
    strip = lambda rs: [{k: v for k, v in r.items() if k != "wall"} for r in rs]
    assert strip(got) == strip(want)
    assert all(isinstance(r["wall"], float) for r in got)


def test_average_meter_matches_jax():
    a, b = logger.AverageMeter(), jlogger.AverageMeter()
    assert a.avg == b.avg == 0.0
    for v, n in ((2.0, 1), (4.0, 3), (torch.tensor(1.0), 2)):
        a.update(v, n)
        b.update(float(v), n)
    assert (a.val, a.sum, a.count, a.avg) == (b.val, b.sum, b.count, b.avg)
    a.reset()
    assert (a.val, a.sum, a.count) == (0.0, 0.0, 0)


def test_get_logger_file_handler(tmp_path):
    assert logger.is_main_process()
    path = tmp_path / "logs" / "train.log"
    log = logger.get_logger("gapro_tpu_torch.test_utils", str(path))
    try:
        assert log.level == logging.INFO
        assert logger.get_logger("gapro_tpu_torch.test_utils") is log  # handlers kept
        log.info("hello %d", 7)
        for h in log.handlers:
            h.flush()
        assert "hello 7" in path.read_text()
        assert sum(isinstance(h, logging.FileHandler) for h in log.handlers) == 1
    finally:
        for h in list(log.handlers):
            h.close()
            log.removeHandler(h)


def test_trace_writes_a_chrome_trace(tmp_path):
    profiling.enable(True)
    try:
        with profiling.trace(str(tmp_path / "trace")) as prof:
            for _ in profiling.units(range(2)):
                with profiling.span("matmul"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
    finally:
        profiling.enable(False)
    assert prof is not None
    assert [s.unit for s in profiling.drain()["spans"]] == [0, 1]
    events = json.load(open(tmp_path / "trace" / profiling.TRACE_FILE))["traceEvents"]
    names = [e.get("name") for e in events]
    assert names.count("gapro.matmul") == 2 and profiling.ANCHOR in names


def test_device_memory_stats_without_a_card(monkeypatch):
    assert profiling.device_memory_stats("cpu") == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.device_memory_stats() == {}
