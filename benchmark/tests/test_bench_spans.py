"""The readers of the program's stage spans and counters: ``idle_ms.*`` and
``host_reads.*`` on made-up traces, ``auction_rounds``, ``radii_solves``
and ``upload_gbps`` on made-up counts; each gives nothing where its span or
counter is absent (the program before the spans and counters). Then the
spans as the benchmark's trace reads them from a traced call of the
program on the CPU, and a traced dry run of a cell."""

import collections
from types import SimpleNamespace

import pytest
import torch

from benchmark import run
from benchmark.tests.helpers import ROOT, small_cell
from benchmark.trace import Trace

DTOH = "Memcpy DtoH (Device -> Pinned)"


def _trace():
    # busy [5, 20), [40, 45), [70, 80): idle 70 ns of the 100 ns window;
    # idle in upload [2, 30): 3 + 10, track [32, 50): 8 + 5, tables
    # [62, 85): 8 + 5; between the spans: 2 + 2 + 12 + 15
    return Trace(
        kernels=[("k1", 5, 15), ("k2", 12, 20), ("k3", 40, 45),
                 ("k4", 70, 80)],
        copies=[(DTOH, 16, 17), ("Memcpy HtoD (Pageable -> Device)", 22, 30),
                ("Memset (Device)", 41, 42),
                ("Memcpy DtoH (Device -> Pageable)", 46, 47),
                (DTOH, 48, 49), (DTOH, 60, 61)],
        host=[("cudaDeviceSynchronize", 0, 2), ("stage.upload", 2, 30),
              ("cudaDeviceSynchronize", 30, 32), ("stage.track", 32, 50),
              ("aten::to", 52, 58), ("stage.tables", 62, 85)],
        window=(0, 100))


def _ctx(trace=None, frames=0, traced_frames=2, timings=None):
    return SimpleNamespace(trace=trace, frames=frames,
                           traced_frames=traced_frames, timings=timings)


def _read(name, ctx):
    return run.reader(ROOT, name)(ctx, name)


def test_idle_ms_splits_the_window_idle_time_exactly():
    tr = _trace()
    ctx = _ctx(tr)
    got = {s: _read(f"idle_ms.{s}", ctx)
           for s in ("upload", "track", "tables", "between")}
    assert got == pytest.approx({"upload": 13e-6 / 2, "track": 13e-6 / 2,
                                 "tables": 13e-6 / 2, "between": 31e-6 / 2},
                                rel=1e-12)
    idle_ms = (tr.window_s - tr.busy_s()) * 1e3 / ctx.traced_frames
    assert sum(got.values()) == pytest.approx(idle_ms, rel=1e-12)
    from benchmark.metrics.idle_ms import idle_ns
    by, stages = idle_ns(tr)
    assert stages == {"upload", "track", "tables"}
    assert sum(by.values()) == 70


def test_host_reads_count_device_to_host_copies_inside_their_span():
    ctx = _ctx(_trace())
    # upload: the DtoH at 16 (not the HtoD); track: those at 46 and 48 (not
    # the set); tables: none (the copy at 60 lies between spans)
    assert _read("host_reads.upload", ctx) == 1 / 2
    assert _read("host_reads.track", ctx) == 2 / 2
    assert _read("host_reads.tables", ctx) == 0.0


@pytest.mark.parametrize("name", ["idle_ms.track", "idle_ms.between",
                                  "host_reads.track"])
def test_span_readers_give_nothing_without_their_span(name):
    tr = _trace()
    assert _read(name, _ctx(None)) is None
    no_spans = Trace(kernels=tr.kernels, copies=tr.copies,
                     host=[(n, s, e) for n, s, e in tr.host
                           if not n.startswith("stage.")],
                     window=tr.window)
    assert _read(name, _ctx(no_spans)) is None
    # no kernel in the trace: a run without the card
    no_card = Trace(copies=tr.copies, host=tr.host, window=tr.window)
    assert _read(name, _ctx(no_card)) is None
    if name != "idle_ms.between":
        other = name.split(".")[0] + ".unet"
        assert _read(other, _ctx(tr)) is None


def test_counter_readers(monkeypatch):
    from tissue_image_processing_tpu_torch import _device

    counts = collections.Counter(auction_rounds=300, radii_solves=16,
                                 upload_bytes=6_400_000_000)
    monkeypatch.setattr(_device, "COUNTS", counts)
    ctx = _ctx(frames=10, timings={"upload": 2.0})
    assert _read("auction_rounds", ctx) == 30.0
    assert _read("radii_solves", ctx) == 1.6
    assert _read("upload_gbps", ctx) == pytest.approx(3.2, rel=1e-12)
    assert _read("upload_gbps", _ctx(frames=10)) is None
    names = ("auction_rounds", "radii_solves", "upload_gbps")
    monkeypatch.setattr(_device, "COUNTS", collections.Counter())
    assert [_read(name, ctx) for name in names] == [None] * 3
    monkeypatch.delattr(_device, "COUNTS")
    assert [_read(name, ctx) for name in names] == [None] * 3


def _small(cell):
    spec, config, traffic = small_cell(cell, 128)
    config.update(frames=3)
    return spec, config, traffic


def test_stage_spans_are_the_host_threads_outermost_operations():
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.movies import make_movie
    from benchmark.programs.movie_pipeline import Program
    from benchmark.trace import WINDOW_MARK, read_profile

    _, config, traffic = _small("ws_raw_2000")
    dev = torch.device("cpu")
    movie = make_movie(traffic, config["frames"], 2 ** 31 + 7, dev)
    program = Program(config, [movie], dev)
    timings = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW_MARK):
            program(movie, timings)
    tr = read_profile(prof)
    spans = [n for n, _, _ in tr.host if n.startswith("stage.")]
    assert {n[len("stage."):] for n in spans} == set(timings)
    assert spans.count("stage.upload") == config["frames"]
    assert spans.count("stage.track") == 1


def test_a_traced_dry_run_reports_the_counters(capsys):
    spec, config, traffic = _small("ws_raw_2000")
    res = run.run_cell(ROOT, "ws_raw_2000", 2 ** 31 + 11, 0.0, True,
                       device="cpu", spec=spec, config=config,
                       traffic=traffic)
    capsys.readouterr()
    m = res["metrics"]
    assert m["auction_rounds"]["value"] >= 2
    assert m["radii_solves"]["value"] > 0
    assert m["upload_gbps"]["value"] > 0
    # no card, no device trace: nothing read from one
    assert not [k for k in m if k.split(".")[0] in ("idle_ms", "host_reads",
                                                    "device_idle")]
