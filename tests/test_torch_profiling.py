"""runtime/profiling.py on the CPU: spans cost no clock read while recording
is off; recorded spans carry their parent, run and host-clock times;
counters are always on and ``since`` filters both; the buffer is bounded;
``phase`` synchronises and logs only under DEBUG; a streaming ``distance``
run records every span of the stage and counts what its inputs and CSV
say; each sweep counts one run and the bytes of its survivors' copy; a
DEBUG ``distance`` logs the totals; a compiler run counts a build."""

import csv
import logging
import math
import os
import time
from datetime import date

import numpy as np
import pytest
import torch

from tracs_tpu_torch import cli as port_cli
from tracs_tpu_torch.ops import recomb
from tracs_tpu_torch.ops.packing import pack_sequences
from tracs_tpu_torch.ops.pairsnp import pairsnp_stream
from tracs_tpu_torch.runtime import build, profiling

#: every span a streaming ``distance --meta --filter`` run records on the CPU
STAGE_SPANS = {"layout.compact", "layout.split", "layout.upload", "sweep.grams",
               "sweep.extract", "filter", "filter.positions", "filter.keep_table",
               "filter.windows", "meta", "meta.dedup", "meta.seed", "meta.k_loop",
               "stage.tail", "stage.format", "stage.write"}


@pytest.fixture
def recorder():
    """Recording on for the test, off after it."""
    profiling.disable()
    profiling.enable()
    yield profiling
    profiling.disable()


def _no_clock():
    raise AssertionError("the clock was read")


def test_span_with_recording_off_reads_no_clock_and_keeps_nothing(monkeypatch):
    profiling.disable()
    t0 = time.perf_counter()
    monkeypatch.setattr(profiling.time, "perf_counter", _no_clock)
    before = profiling.counter("unit.items")
    with profiling.span("unit.off", attr=1) as s:
        assert s is None
    assert profiling.spanned("unit.off")(lambda x: x + 1)(1) == 2
    profiling.count("unit.items", 3)
    monkeypatch.undo()
    assert profiling.counter("unit.items") == before + 3
    trace = profiling.since(t0)
    assert trace.spans == [] and trace.increments == []


def test_recorded_spans_carry_names_nesting_parent_run_and_times(recorder):
    @profiling.run_steps
    def steps():
        for k in range(2):
            with profiling.span("unit.step", k=k):
                pass
            yield k

    t0 = time.perf_counter()
    with profiling.run() as rid:
        with profiling.span("unit.outer"):
            with profiling.span("unit.inner", k=2):
                pass
        for _ in steps():
            with profiling.span("unit.between"):
                pass
    with profiling.span("unit.alone"):
        pass
    lone = list(steps())
    t1 = time.perf_counter()
    spans = profiling.since(t0).spans
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    outer, inner, alone = by["unit.outer"][0], by["unit.inner"][0], by["unit.alone"][0]
    assert [s.name for s in spans][:2] == ["unit.inner", "unit.outer"]  # kept as they end
    assert inner.parent == outer.id and outer.parent is None and inner.attrs == {"k": 2}
    assert outer.run == inner.run == rid and alone.run is None
    # a stepped generator joins the run open when it starts, and starts its
    # own otherwise; its consumer's spans between steps are not its
    assert [s.run for s in by["unit.step"][:2]] == [rid, rid]
    assert {s.run for s in by["unit.step"][2:]} not in ({None}, {rid}) and lone == [0, 1]
    assert [s.run for s in by["unit.between"]] == [rid, rid]
    assert all(s.parent is None for s in by["unit.step"])
    assert all(t0 <= s.t0 <= s.t1 <= t1 for s in spans)
    assert inner.t0 >= outer.t0 and inner.t1 <= outer.t1


def test_counters_are_always_on_and_since_filters_spans_and_increments(recorder):
    profiling.disable()
    before = profiling.counter("unit.items")
    profiling.count("unit.items", 2)
    assert profiling.counter("unit.items") == before + 2
    profiling.enable()
    t0 = time.perf_counter()
    profiling.count("unit.items")
    with profiling.span("unit.first"):
        pass
    t1 = time.perf_counter()
    profiling.count("unit.items", 5)
    with profiling.span("unit.second"):
        pass
    late, all_ = profiling.since(t1), profiling.since(t0)
    assert [s.name for s in late.spans] == ["unit.second"]
    assert late.count("unit.items") == 5 and all_.count("unit.items") == 6
    assert [s.name for s in all_.spans] == ["unit.first", "unit.second"]
    assert profiling.counter("unit.items") == before + 8
    profiling.reset("unit.")
    assert profiling.counter("unit.items") == 0


def test_the_buffer_keeps_the_newest_records_and_counts_the_dropped(monkeypatch):
    profiling.disable()
    monkeypatch.setattr(profiling, "LIMIT", 4)
    dropped = profiling.counter("trace.dropped")
    profiling.enable()
    try:
        for k in range(6):
            with profiling.span(f"unit.s{k}"):
                profiling.count("unit.items")
    finally:
        profiling.disable()
    trace = profiling.since()
    assert [s.name for s in trace.spans] == ["unit.s2", "unit.s3", "unit.s4", "unit.s5"]
    assert len(trace.increments) == 4
    assert profiling.counter("trace.dropped") == dropped + 4


def test_phase_logs_its_seconds_and_takes_a_device(caplog):
    caplog.set_level(logging.DEBUG)
    with profiling.phase("unit work", torch.device("cpu")):
        torch.ones(8).sum()
    with profiling.phase("no device"):
        pass
    lines = [r.getMessage() for r in caplog.records]
    assert any(ln.startswith("[phase] unit work: ") and ln.endswith("s") for ln in lines)
    assert any(ln.startswith("[phase] no device: ") for ln in lines)


def test_phase_synchronises_and_logs_only_under_debug(caplog, monkeypatch, recorder):
    synced = []
    monkeypatch.setattr(profiling, "_sync", synced.append)
    caplog.set_level(logging.INFO)
    t0 = time.perf_counter()
    with profiling.phase("block rows [0,8)", "cuda"):
        pass
    assert synced == [] and caplog.records == []
    caplog.set_level(logging.DEBUG)
    with profiling.phase("block rows [8,16)", "cuda"):
        pass
    assert synced == ["cuda", "cuda"]
    assert caplog.records[-1].getMessage().startswith("[phase] block rows [8,16): ")
    assert [(s.name, s.attrs["label"]) for s in profiling.since(t0).spans] == [
        ("stage.tail", "block rows [0,8)"), ("stage.tail", "block rows [8,16)")]


def _clustered_msa(path, rng, n, L):
    """Samples near three centres with up to 30 changes each, so -D 60
    keeps pairs with many distances."""
    centres = rng.choice(np.array(list("ACGT")), size=(3, L))
    names = [f"c{k}" for k in range(n)]
    with open(path, "w") as fh:
        for k, name in enumerate(names):
            s = centres[k % 3].copy()
            hit = rng.choice(L, size=int(rng.integers(0, 30)), replace=False)
            s[hit] = rng.choice(np.array(list("ACGTNRY-")), size=len(hit))
            fh.write(f">{name}\n{''.join(s)}\n")
    return str(path), names


def _write_dates(path, names, rng):
    days = {name: date.fromordinal(date(2019, 1, 1).toordinal() + int(rng.integers(0, 400)))
            for name in names}
    with open(path, "w") as fh:
        fh.write("name,date\n")
        fh.writelines(f"{name},{day.isoformat()}\n" for name, day in days.items())
    return str(path), days


def _stream_job(tmp_path, extra=()):
    rng = np.random.default_rng(17)
    msa, names = _clustered_msa(tmp_path / "c.aln", rng, 37, 900)
    dates, days = _write_dates(tmp_path / "dates.csv", names, rng)
    out = tmp_path / "out.csv"
    recomb._keep_tables.clear()  # a distance process starts with none
    port_cli.main(["distance", "--msa", msa, "--meta", dates, "--filter", "-D", "60",
                   "--row-block", "8", "--device", "cpu", "-o", str(out), *extra])
    with open(out) as fh:
        rows = list(csv.DictReader(fh))
    return rows, days, len(names)


def test_a_streaming_run_records_every_span_and_counts_what_its_inputs_say(tmp_path,
                                                                            recorder):
    t0 = time.perf_counter()
    rows, days, n = _stream_job(tmp_path)
    trace = profiling.since(t0)
    # (a first use of the native library in this process builds it)
    assert set(trace.table()) - {"kernel.build"} == STAGE_SPANS
    assert len({s.run for s in trace.spans}) == 1 and trace.spans[0].run is not None
    # the counters, against the CSV and the inputs
    assert trace.count("stage.runs") == trace.count("sweep.runs") == 1
    assert trace.count("sweep.survivors") == len(rows) > 0
    assert trace.count("sweep.copied_bytes") == 16 * len(rows)
    assert trace.count("sweep.blocks") == math.ceil(n / 8)
    assert trace.count("sweep.pairs") == sum((min(n, r0 + 8) - r0) * (n - r0)
                                             for r0 in range(0, n, 8))
    years = [abs((days[r["sampleA"]] - days[r["sampleB"]]).days) * 86400.0 / 31556952.0
             for r in rows]
    lanes = {(int(r["filtered SNP distance"]), y) for r, y in zip(rows, years)}
    assert trace.count("meta.lanes") == len(lanes)
    assert trace.count("filter.keep_table_builds") == len(
        {int(r["SNP distance"]) for r in rows if int(r["SNP distance"]) > 1}) > 1
    assert trace.count("meta.k_steps") >= 8 * trace.count("meta.k_blocks") > 0
    assert trace.count("layout.upload_bytes") > 0
    # self times leave out the children: the model's own time is what its
    # children do not cover
    table = trace.table()
    assert 0 <= table["meta"][2] <= table["meta"][1]
    assert table["stage.tail"][0] == math.ceil(n / 8)


@pytest.mark.parametrize("method", ["split", "popcount", "mxu"])
def test_each_sweep_counts_one_run_and_copies_16_bytes_a_survivor(method):
    rng = np.random.default_rng(23)
    msa = rng.choice(np.array(list("ACGTNR")), p=[0.24] * 4 + [0.02, 0.02], size=(29, 700))
    hit = rng.random(msa.shape) < 0.98
    msa[hit] = msa[0][np.nonzero(hit)[1]]  # near one genome: some pairs within -D 12
    packed = pack_sequences(["".join(row) for row in msa])
    names = ("sweep.runs", "sweep.blocks", "sweep.survivors", "sweep.copied_bytes")
    before = [profiling.counter(k) for k in names]
    survivors = 0
    for _ in range(2):
        stream = pairsnp_stream([packed], dist=12, row_block=8, device="cpu", method=method,
                                compact=False)
        survivors += sum(len(block[3]) for block in stream)
    # a stream resumed past its last row sweeps nothing and counts no run
    assert list(pairsnp_stream([packed], start_row=29, device="cpu", method=method)) == []
    runs, blocks, counted, copied = (profiling.counter(k) - b for k, b in zip(names, before))
    assert runs == 2 and blocks == 2 * math.ceil(29 / 8)
    assert copied == 16 * counted == 16 * survivors > 0


def test_a_debug_distance_run_logs_span_totals_and_counters(tmp_path, caplog):
    caplog.set_level(logging.DEBUG)
    rows, _days, _n = _stream_job(tmp_path, ["--loglevel", "DEBUG"])
    lines = [r.getMessage() for r in caplog.records]
    assert not profiling.recording()
    spans = {ln.split(":")[0][len("[span] "):] for ln in lines if ln.startswith("[span] ")}
    assert spans - {"kernel.build"} == STAGE_SPANS
    assert f"[count] sweep.survivors: {len(rows)}" in lines
    assert any(ln.startswith("[rate] ") and "pairs in" in ln for ln in lines)
    assert any(ln.startswith("[phase] block rows [0,8): ") for ln in lines)


def test_a_compiler_run_counts_one_build_and_a_cached_load_none(tmp_path, recorder):
    src = os.path.join(build.CSRC_DIR, "mism_plan.cpp")
    argv = ["g++", "-O0", "-std=c++17", "-shared", "-fPIC", src, "-o", "{out}"]
    before = profiling.counter("kernel.builds")
    t0 = time.perf_counter()
    path, _ = build.compile_library(src, str(tmp_path / "native"), "mism_plan", argv)
    assert profiling.counter("kernel.builds") == before + 1 and os.path.exists(path)
    again, out = build.compile_library(src, str(tmp_path / "native"), "mism_plan", argv)
    assert again == path and out == ""
    assert profiling.counter("kernel.builds") == before + 1
    assert [(s.name, s.attrs) for s in profiling.since(t0).spans] == [
        ("kernel.build", {"lib": "mism_plan"})]
